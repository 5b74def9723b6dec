"""Plain PyTorch versions of the selection kernels.

They mirror ``repro.kernels.ref`` and are what the kernel wrappers run
for a tensor on the CPU; ``chip_smoke.py`` holds each CUDA kernel to its
plain version on the card, bit for bit.

Ordering: ``lax.top_k`` breaks magnitude ties toward the lowest index and
``torch.topk`` promises no order among ties, so every selection here
orders with a stable descending sort instead (equal magnitudes keep
their index order).
"""
from __future__ import annotations

import torch


def topk_order(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (int64) of the top-``k`` of ``mag`` along the last axis,
    descending, ties toward the lowest index."""
    return torch.sort(mag, dim=-1, descending=True, stable=True)[1][..., :k]


def block_topk_ref(blocks: torch.Tensor, r: int):
    """Per-row top-``r`` by magnitude of ``blocks`` (n, bs).

    Returns (values (n, r) in ``blocks``' dtype with sign kept, local
    indices (n, r) int32), by descending magnitude."""
    idx = topk_order(blocks.abs().float(), r)
    return torch.gather(blocks, -1, idx), idx.to(torch.int32)


def _accumulate(g_rows, e_rows, lr):
    """acc = e + lr·g in f32, rounded twice (product, then sum)."""
    return e_rows.float() + lr * g_rows.float()


def ef_accum_sparsify_ref(g, e, lr, thr):
    """Fused error-feedback accumulate + magnitude-threshold sparsify,
    elementwise over same-shape ``g`` (f32 or bf16) and ``e`` (f32):

        acc      = e + lr·g            (Algorithm 1 line 7)
        selected = acc·[|acc| >= thr]  (top-k as a threshold, Eq. 4)
        residual = acc − selected      (Algorithm 1 line 8)

    ``lr`` and ``thr``: Python floats or one-element f32 tensors.
    Returns (selected, residual), both f32."""
    acc = _accumulate(g, e, lr)
    keep = acc.abs() >= torch.as_tensor(thr, dtype=torch.float32,
                                         device=acc.device)
    selected = torch.where(keep, acc, torch.zeros((), dtype=acc.dtype,
                                                  device=acc.device))
    return selected, acc - selected


def ef_select_pack_ref(g_rows, e_rows, lr, thr, k: int):
    """Fused EF accumulate + per-row top-``k`` + payload pack.

    acc = e + lr·g (f32); per row the top-``k`` of |acc| are packed as
    (values, local int32 indices); a pick whose magnitude falls below
    ``thr`` is emitted as value 0 with its in-range index (the
    scatter-ADD padding contract); residual = acc − scatter(values).
    ``thr=None`` disables the gate.  ``thr`` may also be a tensor of
    shape (n // group,) giving one threshold per group of consecutive
    rows.  Returns (vals (n, k) f32, idx (n, k) int32, residual (n, bs)
    f32).
    """
    acc = _accumulate(g_rows, e_rows, lr)
    mag = acc.abs()
    idx = topk_order(mag, k)
    raw = torch.gather(acc, -1, idx)
    if thr is None:
        vals = raw
    else:
        thr_t = torch.as_tensor(thr, dtype=torch.float32, device=acc.device)
        if thr_t.ndim:
            thr_t = thr_t.repeat_interleave(acc.shape[0] // thr_t.shape[0])
            thr_t = thr_t[:, None]
        keep = torch.gather(mag, -1, idx) >= thr_t
        vals = torch.where(keep, raw, torch.zeros((), dtype=raw.dtype,
                                                  device=raw.device))
    selected = torch.zeros_like(acc).scatter_add_(-1, idx, vals)
    return vals, idx.to(torch.int32), acc - selected


def ef_block_candidates_ref(g_rows, e_rows, lr, r: int):
    """Per-row top-``r`` candidates of acc = e + lr·g: the pack oracle
    with the gate off and no residual.  Returns (vals (n, r) f32, idx
    (n, r) int32)."""
    acc = _accumulate(g_rows, e_rows, lr)
    idx = topk_order(acc.abs(), r)
    return torch.gather(acc, -1, idx), idx.to(torch.int32)
