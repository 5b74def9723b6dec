"""Fused error-feedback selection: wrappers of the CUDA ``ef_select_pack``
and ``ef_block_candidates`` kernels.

Replace ``repro.kernels.ef_sparsify.ef_select_pack_pallas`` (EF
accumulate + per-row top-k + payload pack + residual, ``acc = e + lr·g``
never in device memory) and ``ef_block_candidates_pallas`` (the same
accumulate, emitting only each row's top-r: stage 1 of
``ops.ef_hier_pack``).  A CPU tensor runs the plain version
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


ef_select_pack.launches = 0
ef_block_candidates.launches = 0
