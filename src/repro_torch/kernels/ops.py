"""The logic around the selection kernels, as ``repro.kernels.ops`` has
it: block views and padding, the clamp of global indices to ``d - 1``,
the ``d <= block_size`` exact degeneracy, and stage 2 of the
hierarchical selection (the k-th candidate magnitude, plain torch with a
stable sort).  One addition: a budget that keeps every entry (k >= d,
or k_b = bs) skips the selection (:func:`keep_all_rows`), since a single
row of a large leaf does not fit the kernel's shared memory and a
k_b = bs pack costs bs arg-max passes per row for nothing.

Every function takes vectors with any leading axes, ``(..., d)``, and
selects along the last one: the P workers of the simulation surface run
as one launch per leaf, ``P·n_blocks`` rows.  Rows are independent, so
this is the same as one call per worker.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ef_sparsify as _ef
from repro_torch.kernels import ref
from repro_torch.kernels.block_topk import block_topk


def block_view(x: torch.Tensor, n_blocks: int, bs: int) -> torch.Tensor:
    """(..., d) -> (prod(...)·n_blocks, bs), zero-padded at the tail;
    a view when ``d`` fills the blocks exactly."""
    d = x.shape[-1]
    x = x.reshape(-1, d)
    pad = n_blocks * bs - d
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(-1, bs)


def global_index(local: torch.Tensor, n_blocks: int, bs: int,
                 d: int) -> torch.Tensor:
    """(P·n_blocks, r) local indices -> (P, n_blocks·r) global int32,
    clamped into [0, d): a short tail block's zero padding carries value
    0, so the clamp keeps the scatter-ADD a no-op and the int32 payload
    in range."""
    base = torch.arange(n_blocks, dtype=torch.int32,
                        device=local.device)[:, None] * bs
    r = local.shape[-1]
    glob = local.reshape(-1, n_blocks, r) + base
    return torch.clamp_max(glob.reshape(-1, n_blocks * r), d - 1)


def kth_magnitude(cand: torch.Tensor, k: int) -> torch.Tensor:
    """(P, c) candidate values -> (P,) k-th largest |value| (k clamped
    to c)."""
    kk = min(k, cand.shape[-1])
    mags = torch.sort(cand.abs(), dim=-1, descending=True, stable=True)[0]
    return mags[..., kk - 1].contiguous()


def hier_topk_threshold(x: torch.Tensor, k: int, *, block_size: int = 4096,
                        r: int = 4):
    """Stage 1 + 2 of the hierarchical top-k: the selection threshold.

    Returns (thr (...,), (cand_vals (..., n_blocks·r), cand_idx
    (..., n_blocks·r) int32))."""
    lead, d = x.shape[:-1], x.shape[-1]
    n_blocks = -(-d // block_size)
    r_eff = min(r, block_size)
    cand_vals, cand_local = block_topk(block_view(x, n_blocks, block_size),
                                       r_eff)
    cand_idx = global_index(cand_local, n_blocks, block_size, d)
    cand_flat = cand_vals.reshape(-1, n_blocks * r_eff)
    thr = kth_magnitude(cand_flat, k)
    shape = lead + (n_blocks * r_eff,)
    return thr.reshape(lead), (cand_flat.reshape(shape),
                               cand_idx.reshape(shape))


def ef_accum_sparsify(g, e, lr, thr):
    """Fused ``acc = e + lr·g``; ``selected = acc·[|acc| >= thr]``;
    ``residual = acc − selected`` on flat ``(d,)`` vectors (any leading
    axes are fine: the pass is elementwise).  ``thr`` is typically the
    k-th magnitude from :func:`hier_topk_threshold`.  Returns (selected,
    residual), f32."""
    return _ef.ef_accum_sparsify(g, e, lr, thr)


def keep_all_rows(g_rows, e_rows, lr):
    """The ungated pack at k = bs, where every entry is kept, without a
    selection: (vals = acc (n, bs) f32 in index order, local idx
    arange(bs) int32, residual zeros).  The kernel's payload is ordered
    by magnitude instead; the scatter of either gives the same mean bit
    for bit (one row's indices are distinct) and its residual is
    acc − acc = +0, so the exchanges' mean and residual do not depend on
    the order.  The accumulate rounds as the kernel's does."""
    acc = ref._accumulate(g_rows, e_rows, lr)
    n, bs = acc.shape
    idx = torch.arange(bs, dtype=torch.int32, device=acc.device)
    return acc, idx.expand(n, bs), torch.zeros_like(acc)


def ef_select_pack_rows(g_rows, e_rows, lr, thr, k: int):
    """Fused EF accumulate + per-row top-``k`` + payload pack on a block
    view; ``thr=None`` disables the gate.  Returns (vals (n, k) f32,
    local idx (n, k) int32, residual (n, bs) f32)."""
    return _ef.ef_select_pack(g_rows, e_rows, lr, thr, k)


def ef_block_pack(g, e, lr, k: int, *, block_size: int = 4096):
    """``topk_block`` geometry (k_b = ceil(k·bs/d) kept per block) fused
    with the EF accumulate in one pass.

    g: (..., d) f32 or bf16; e: (..., d) f32.  Returns (vals (...,
    n_blocks·k_b) f32, global idx int32 clamped into [0, d), residual
    (..., d) f32)."""
    lead, d = g.shape[:-1], g.shape[-1]
    bs = min(block_size, d)
    n_blocks = -(-d // bs)
    k_b = max(1, min(bs, -(-k * bs // d)))
    g_rows, e_rows = block_view(g, n_blocks, bs), block_view(e, n_blocks, bs)
    if k_b == bs:                       # every entry kept: no selection
        vals, local, res = keep_all_rows(g_rows, e_rows, lr)
    else:
        vals, local, res = ef_select_pack_rows(g_rows, e_rows, lr, None, k_b)
    idx = global_index(local, n_blocks, bs, d)
    res = res.reshape(-1, n_blocks * bs)[:, :d]
    return (vals.reshape(lead + (-1,)), idx.reshape(lead + (-1,)),
            res.reshape(lead + (d,)))


def ef_hier_pack(g, e, lr, k: int, *, block_size: int = 4096, r: int = 4):
    """Hierarchical fused EF: candidate kernel -> k-th candidate magnitude
    -> threshold-gated pack kernel; ``acc`` never materializes.

    At most ``r`` entries per block pass the gate; threshold ties may keep
    slightly more than k (the bias stays in the EF residual).  For
    ``d <= block_size`` (or ``k >= d``) the one block degenerates to an
    exact fused top-k; ``k >= d`` keeps every entry with no selection
    (:func:`keep_all_rows`: values in index order, the residual zeros).
    Returns (vals f32, global idx int32 in [0, d), residual (..., d)
    f32), the first two of shape (..., n_blocks·r) (``k >= d``: d)."""
    lead, d = g.shape[:-1], g.shape[-1]
    if k >= d:
        vals, idx, res = keep_all_rows(g.reshape(-1, d), e.reshape(-1, d),
                                       lr)
        return (vals.reshape(lead + (d,)), idx.reshape(lead + (d,)),
                res.reshape(lead + (d,)))
    if d <= block_size:
        vals, local, res = ef_select_pack_rows(
            g.reshape(-1, d), e.reshape(-1, d), lr, None, k)
        return (vals.reshape(lead + (k,)), local.reshape(lead + (k,)),
                res.reshape(lead + (d,)))
    bs = block_size
    n_blocks = -(-d // bs)
    r_eff = min(r, bs)
    g_rows = block_view(g, n_blocks, bs)
    e_rows = block_view(e, n_blocks, bs)
    cand_vals, _ = _ef.ef_block_candidates(g_rows, e_rows, lr, r_eff)
    thr = kth_magnitude(cand_vals.reshape(-1, n_blocks * r_eff), k)
    vals, local, res = ef_select_pack_rows(g_rows, e_rows, lr, thr, r_eff)
    idx = global_index(local, n_blocks, bs, d)
    res = res.reshape(-1, n_blocks * bs)[:, :d]
    return (vals.reshape(lead + (-1,)), idx.reshape(lead + (-1,)),
            res.reshape(lead + (d,)))

