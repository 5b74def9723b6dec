"""Stand-ins for every model input, per (arch × shape), as
``repro.launch.specs`` has them: ``meta`` tensors (shape and dtype, no
storage) in place of ``jax.ShapeDtypeStruct``s, and
:func:`concrete_batch` to materialise one.  The modality frontends are
stubs, as in the reference: a VLM takes precomputed patch embeddings
(its ``n_frontend_tokens``, at most half the sequence, ahead of the
text), an audio encoder-decoder conv-subsampled frame embeddings
(:func:`audio_frames`), both (B, N, d_model) in the config's dtype.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L


def audio_frames(seq_len: int) -> int:
    """Conv-subsampled audio frames of a ``seq_len`` input (~4x)."""
    return max(seq_len // 4, 1)


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg, shape):
    """Global-shape train/prefill batch: ``{"tokens", "labels"?,
    "frontend_embeds"?}``.  A VLM's ``seq_len`` holds ``n_f =
    min(n_frontend_tokens, seq_len // 2)`` patches and ``seq_len - n_f``
    tokens; an audio model's is all tokens, beside
    ``audio_frames(seq_len)`` frames."""
    b, s = shape.global_batch, shape.seq_len
    n_text = s
    if cfg.frontend == "vision":
        n_f = min(cfg.n_frontend_tokens, s // 2)
        n_text = s - n_f
    elif cfg.frontend == "audio":
        n_f = audio_frames(s)
    out = {"tokens": _meta((b, n_text))}
    if cfg.frontend is not None:
        out["frontend_embeds"] = _meta((b, n_f, cfg.d_model),
                                       L.DTYPES[cfg.dtype])
    if shape.kind == "train":
        out["labels"] = _meta((b, n_text))
    return out


def decode_batch_specs(cfg, shape):
    """One-token decode inputs: ``{"token": (B, 1), "pos": scalar}``."""
    return {"token": _meta((shape.global_batch, 1)), "pos": _meta(())}


def concrete_batch(cfg, shape, *, seed: int = 0, device="cuda"):
    """A batch matching :func:`train_batch_specs`: uniform tokens in
    [0, vocab) from a generator seeded with ``seed`` (tokens and labels
    the same draw, as the reference's one key gives), and the frontend's
    embeddings from a standard normal, in the config's dtype, from a
    generator of their own (seeded with ``seed + 1``: the reference
    splits its key)."""
    dev = resolve_device(device)
    out = {}
    for name, sd in train_batch_specs(cfg, shape).items():
        gen = torch.Generator(device=dev)
        if name == "frontend_embeds":
            gen.manual_seed(seed + 1)
            out[name] = torch.randn(tuple(sd.shape), generator=gen,
                                    device=dev).to(sd.dtype)
            continue
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
