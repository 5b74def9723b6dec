"""Fused error-feedback selection: wrappers of the CUDA ``ef_select_pack``,
``ef_block_candidates`` and ``ef_accum_sparsify`` kernels.

Replace ``repro.kernels.ef_sparsify.ef_select_pack_pallas`` (EF
accumulate + per-row top-k + payload pack + residual, ``acc = e + lr·g``
never in device memory), ``ef_block_candidates_pallas`` (the same
accumulate, emitting only each row's top-r: stage 1 of
``ops.ef_hier_pack``) and ``ef_accum_sparsify_pallas`` (the same
accumulate with a magnitude threshold, elementwise: selected and
residual).  A CPU tensor runs the plain version
(``repro_torch.kernels.ref``); a CUDA tensor launches the kernel or
raises.

``lr`` and ``thr`` reach the kernels as f32 scalars in device memory
(no host sync): a Python float is written to the device first.  ``thr``
may hold one threshold per group of consecutive rows — the workers of
a stacked (P·n_blocks, bs) launch each have their own.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.block_topk import (DTYPES, check_k, check_rows,
                                            stream_of)


def _device_scalar(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if x.device != device or x.dtype != torch.float32 or x.numel() != 1:
            raise ValueError(f"scalar must be one f32 on {device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        return x.reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _thr_arg(thr, n: int, device):
    """(device tensor or None, rows per threshold)."""
    if thr is None:
        return None, 1
    if isinstance(thr, torch.Tensor) and thr.ndim == 1:
        if thr.device != device or thr.dtype != torch.float32:
            raise ValueError("thr must be f32 on the rows' device")
        if thr.numel() == 0 or n % thr.numel():
            raise ValueError(f"{thr.numel()} thresholds do not divide "
                             f"{n} rows")
        return thr.contiguous(), n // thr.numel()
    return _device_scalar(thr, device), max(n, 1)


def _check_ge(name, g_rows, e_rows):
    check_rows(f"{name} g", g_rows, DTYPES)
    check_rows(f"{name} e", e_rows, (torch.float32,), tuple(g_rows.shape))
    if e_rows.device != g_rows.device:
        raise ValueError(f"{name}: g and e on different devices")


def ef_select_pack(g_rows, e_rows, lr, thr, k: int):
    """Fused EF accumulate + per-row top-``k`` + payload pack.

    g_rows: (n, bs) f32 or bf16; e_rows: (n, bs) f32; ``thr=None`` turns
    the gate off.  Returns (vals (n, k) f32, local idx (n, k) int32,
    residual (n, bs) f32)."""
    if g_rows.device.type == "cpu":
        return ref.ef_select_pack_ref(g_rows, e_rows, lr, thr, k)
    _check_ge("ef_select_pack", g_rows, e_rows)
    n, bs = g_rows.shape
    check_k("ef_select_pack", k, bs, 8 * bs)
    dev = g_rows.device
    lr_t = _device_scalar(lr, dev)
    thr_t, group = _thr_arg(thr, n, dev)
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    res = torch.empty((n, bs), dtype=torch.float32, device=dev)
    if n:
        with torch.cuda.device(dev):
            err = build.lib().ef_select_pack(
                g_rows.data_ptr(), int(g_rows.dtype == torch.bfloat16),
                e_rows.data_ptr(), lr_t.data_ptr(),
                None if thr_t is None else thr_t.data_ptr(), group,
                vals.data_ptr(), idx.data_ptr(), res.data_ptr(), n, bs, k,
                stream_of(g_rows))
        build.check("ef_select_pack", err)
        ef_select_pack.launches += 1
    return vals, idx, res


def ef_block_candidates(g_rows, e_rows, lr, r: int):
    """Per-row top-``r`` candidates of ``acc = e + lr·g``, accumulate
    fused.  Returns (vals (n, r) f32, local idx (n, r) int32)."""
    if g_rows.device.type == "cpu":
        return ref.ef_block_candidates_ref(g_rows, e_rows, lr, r)
    _check_ge("ef_block_candidates", g_rows, e_rows)
    n, bs = g_rows.shape
    check_k("ef_block_candidates", r, bs, 8 * bs)
    dev = g_rows.device
    lr_t = _device_scalar(lr, dev)
    vals = torch.empty((n, r), dtype=torch.float32, device=dev)
    idx = torch.empty((n, r), dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            err = build.lib().ef_block_candidates(
                g_rows.data_ptr(), int(g_rows.dtype == torch.bfloat16),
                e_rows.data_ptr(), lr_t.data_ptr(), vals.data_ptr(),
                idx.data_ptr(), n, bs, r, stream_of(g_rows))
        build.check("ef_block_candidates", err)
        ef_block_candidates.launches += 1
    return vals, idx


def ef_accum_sparsify(g, e, lr, thr):
    """Fused ``acc = e + lr·g``; ``selected = acc·[|acc| >= thr]``;
    ``residual = acc − selected``, elementwise.

    g: f32 or bf16, e: f32, both contiguous and of one shape (any);
    ``lr``/``thr``: Python floats or one f32 on ``g``'s device.  Returns
    (selected, residual), f32, of that shape.  Contract: on the card the
    kernel is bitwise equal to its plain version
    (``ref.ef_accum_sparsify_ref``) at every lr, and the plain version is
    bitwise equal to ``repro.kernels.ref.ef_accum_sparsify_ref`` at
    lr = 1 and within rtol = atol = 1e-6 (the reference's own kernel
    tolerance) elsewhere, where XLA may contract ``e + lr·g`` into one
    fma."""
    if g.device.type == "cpu":
        return ref.ef_accum_sparsify_ref(g, e, lr, thr)
    for name, t, dtypes in (("g", g, DTYPES), ("e", e, (torch.float32,))):
        if t.device.type != "cuda":
            raise ValueError(f"ef_accum_sparsify {name}: expected a CUDA "
                             f"tensor, got {t.device}")
        if t.dtype not in dtypes:
            raise ValueError(f"ef_accum_sparsify {name}: dtype {t.dtype} "
                             f"not in {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"ef_accum_sparsify {name}: tensor must be "
                             f"contiguous")
    if e.shape != g.shape or e.device != g.device:
        raise ValueError(f"ef_accum_sparsify: g {tuple(g.shape)} on "
                         f"{g.device} and e {tuple(e.shape)} on {e.device}")
    dev = g.device
    lr_t = _device_scalar(lr, dev)
    thr_t = _device_scalar(thr, dev)
    sel = torch.empty(g.shape, dtype=torch.float32, device=dev)
    res = torch.empty(g.shape, dtype=torch.float32, device=dev)
    if g.numel():
        with torch.cuda.device(dev):
            err = build.lib().ef_accum_sparsify(
                g.data_ptr(), int(g.dtype == torch.bfloat16), e.data_ptr(),
                lr_t.data_ptr(), thr_t.data_ptr(), sel.data_ptr(),
                res.data_ptr(), g.numel(), stream_of(g))
        build.check("ef_accum_sparsify", err)
        ef_accum_sparsify.launches += 1
    return sel, res


ef_select_pack.launches = 0
ef_block_candidates.launches = 0
ef_accum_sparsify.launches = 0
