"""Stand-ins for every model input, per (arch × shape), as
``repro.launch.specs`` has them: ``meta`` tensors (shape and dtype, no
storage) in place of ``jax.ShapeDtypeStruct``s, and
:func:`concrete_batch` to materialise one.  The modality frontends
(vision patches, audio frames) are not ported: a config with a frontend
raises, naming ROADMAP.md queue 1 item 13d.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device


def audio_frames(seq_len: int) -> int:
    """Conv-subsampled audio frames of a ``seq_len`` input (~4x): the
    reference's arithmetic (its audio frontend itself is item 13d)."""
    return max(seq_len // 4, 1)


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg, shape):
    """Global-shape train/prefill batch: ``{"tokens", "labels"?}``."""
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend's inputs are not "
            f"ported yet (ROADMAP.md queue 1 item 13d: frontends)")
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((b, s))}
    if shape.kind == "train":
        out["labels"] = _meta((b, s))
    return out


def decode_batch_specs(cfg, shape):
    """One-token decode inputs: ``{"token": (B, 1), "pos": scalar}``."""
    return {"token": _meta((shape.global_batch, 1)), "pos": _meta(())}


def concrete_batch(cfg, shape, *, seed: int = 0, device="cuda"):
    """A batch matching :func:`train_batch_specs`, uniform tokens in
    [0, vocab) from a generator seeded with ``seed`` (every field the
    same draw, as the reference's one key gives)."""
    dev = resolve_device(device)
    out = {}
    for name, sd in train_batch_specs(cfg, shape).items():
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        out[name] = torch.randint(0, cfg.vocab, tuple(sd.shape),
                                  generator=gen, device=dev,
                                  dtype=torch.int32)
    return out


def supports_shape(cfg, shape) -> bool:
    """long_500k only for sub-quadratic archs (SSM/hybrid/sliding-window)."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True
