"""Serving launch: the prefill and decode steps of
``repro.launch.serve``, on one device.

No gradients, so no LAGS here.  The reference lays the parameters and
caches out over a TPU mesh with GSPMD (tensor parallelism over
``model``, FSDP where a copy would not fit its device); the port places
everything on the device that holds the parameters.  A mesh with a
``model`` axis larger than 1 raises (ROADMAP.md queue 1 item 7's
tensor-parallel tail).  The steps' argument specs are ``meta`` tensors
(shapes and dtypes, no storage), the counterpart of the reference's
``ShapeDtypeStruct``s: a step applied to them returns ``meta`` outputs of
the right shapes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch import specs as SP
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import engine


def serve_cfg(cfg, shape_name: str):
    """Long-context serving mode: gemma3's global layers fall back to the
    sliding window (documented deviation) so 500k decode is O(window)."""
    if shape_name == "long_500k" and cfg.local_global_period:
        return dataclasses.replace(cfg, local_global_period=None)
    return cfg


def check_mesh(mesh) -> None:
    """Raise for a mesh the one-device serving path cannot take."""
    if mesh is None:
        return
    names = tuple(mesh.mesh_dim_names or ())
    if "model" in names and mesh.size(names.index("model")) > 1:
        raise NotImplementedError(
            "serving over a model axis > 1 (tensor parallelism) is not "
            "ported yet (ROADMAP.md queue 1 item 7, its tensor-parallel "
            "tail)")


def state_specs(cfg, mesh, shape):
    """``meta`` stand-ins for decode: ``{"params", "states"}`` at
    ``shape``'s batch and capacity (an audio model's cross caches hold
    ``audio_frames(seq_len)`` slots), and the resolved serving config."""
    check_mesh(mesh)
    cfg = serve_cfg(cfg, shape.name)
    enc_len = SP.audio_frames(shape.seq_len) if cfg.frontend == "audio" \
        else 0
    states = engine.init_states(cfg, shape.global_batch, shape.seq_len,
                                L.DTYPES[cfg.dtype], enc_len=enc_len,
                                device="meta")
    return {"params": T.abstract_params(cfg), "states": states}, cfg


def make_serve_step(cfg, mesh, shape, *, chunk: int = 2048):
    """One-token decode step against a ``shape.seq_len`` cache.  Returns
    (fn(params, token, states, pos) -> (logits, states), arg specs);
    ``fn`` writes the states in place, as the reference's donated step
    does."""
    sds, cfg2 = state_specs(cfg, mesh, shape)

    def fn(params, token, states, pos):
        return engine.serve_step(params, cfg2, token, states, pos,
                                 chunk=chunk)

    batch = SP.decode_batch_specs(cfg2, shape)
    return fn, (sds["params"], batch["token"], sds["states"], batch["pos"])


def make_prefill_step(cfg, mesh, shape, *, chunk: int = 1024):
    """Prompt prefill: returns (fn(params, batch) -> (logits, states),
    arg specs).  Resolves the same :func:`serve_cfg` rewrite
    :func:`state_specs` applies, so the caches prefill builds agree with
    the ones decode expects: under ``long_500k`` a gemma3 global layer
    prefills with the window it will decode with."""
    check_mesh(mesh)
    cfg = serve_cfg(cfg, shape.name)

    def fn(params, batch):
        return engine.prefill(params, cfg, batch["tokens"],
                              frontend_embeds=batch.get("frontend_embeds"),
                              chunk=chunk)

    return fn, (T.abstract_params(cfg), SP.train_batch_specs(cfg, shape))
