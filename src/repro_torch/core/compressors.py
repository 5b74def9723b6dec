"""Gradient compressors, as ``repro.core.compressors`` defines them.

    compress(x, k)   -> (values, indices)   # fixed-size sparse form
    decompress(values, indices, d) -> dense vector in R^d

Every function selects along the last axis of ``x`` (``(..., d)``), so
the P workers of the simulation surface run together.  Exactness tiers:

  * ``topk_exact`` — exact top-k by magnitude, ties to the lowest index.
  * ``topk_hier``  — block-local top-r candidates, then exact top-k over
    them (exact unless a block holds more than r of the true top-k).
  * ``topk_block`` — a fixed per-block budget k_b = ceil(k·bs/d), no
    global selection at all.

``*_kernel`` / ``*_ef_kernel`` variants run the CUDA kernels of
``repro_torch.kernels``; the ``*_ef_kernel`` ones carry a
``fused_select`` that fuses EF accumulate, selection, payload pack and
residual.  ``KERNEL_BACKED`` maps each name to the variant that
``selection_backend="kernel"`` swaps in.  ``randk`` and
``topk_sampled`` are not ported yet (ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref


def _abs_topk(x: torch.Tensor, k: int):
    """Exact top-k by magnitude. Returns (values with sign, int32 idx)."""
    idx = ref.topk_order(x.abs(), k)
    return torch.gather(x, -1, idx), idx.to(torch.int32)


def topk_exact_compress(x: torch.Tensor, k: int):
    return _abs_topk(x, k)


def topk_hier_compress(x: torch.Tensor, k: int, *, block_size: int = 4096,
                       r: int = 4, use_kernel: bool = False):
    """Two-stage hierarchical top-k: per-block top-``r`` candidates
    (the ``block_topk`` kernel when ``use_kernel``), then exact top-k
    over the candidates."""
    lead, d = x.shape[:-1], x.shape[-1]
    if d <= block_size or k >= d:
        return _abs_topk(x, min(k, d))
    n_blocks = -(-d // block_size)
    blocks = kops.block_view(x, n_blocks, block_size)
    r_eff = min(r, block_size)
    if use_kernel:
        cand_vals, cand_local = kops.block_topk(blocks, r_eff)
    else:
        cand_vals, cand_local = ref.block_topk_ref(blocks, r_eff)
    cand_idx = kops.global_index(cand_local, n_blocks, block_size, d)
    cand_vals = cand_vals.reshape(-1, n_blocks * r_eff)
    kk = min(k, cand_vals.shape[-1])
    sel = ref.topk_order(cand_vals.abs(), kk)
    vals = torch.gather(cand_vals, -1, sel)
    idx = torch.gather(cand_idx, -1, sel)
    if kk < k:  # degenerate (tiny d): zero values on the last index
        vals = torch.nn.functional.pad(vals, (0, k - kk))
        idx = torch.cat([idx, idx[:, -1:].expand(-1, k - kk)], -1)
    return vals.reshape(lead + (k,)), idx.reshape(lead + (k,))


def topk_block_compress(x: torch.Tensor, k: int, *, block_size: int = 4096,
                        use_kernel: bool = False):
    """Fixed per-block budget: k_b = ceil(k·bs/d) kept in every block of
    ``block_size`` (the ``block_topk`` kernel when ``use_kernel``).
    Padded tail positions carry value 0 with indices clamped to d - 1."""
    lead, d = x.shape[:-1], x.shape[-1]
    if k >= d:
        idx = torch.arange(d, dtype=torch.int32, device=x.device)
        return x, idx.expand(lead + (d,))
    bs = min(block_size, d)
    n_blocks = -(-d // bs)
    k_b = max(1, min(bs, -(-k * bs // d)))
    blocks = kops.block_view(x, n_blocks, bs)
    if use_kernel:
        vals, local = kops.block_topk(blocks, k_b)
    else:
        vals, local = ref.block_topk_ref(blocks, k_b)
    idx = kops.global_index(local, n_blocks, bs, d)
    return vals.reshape(lead + (-1,)), idx.reshape(lead + (-1,))


# -- fused kernel-backed selection (EF accumulate + select + pack) ----------

def topk_block_ef_select(u, e, k: int, *, block_size: int = 4096):
    """Fused block-budget EF select; bitwise equal to ``topk_block`` on
    ``acc = e + u``."""
    return kops.ef_block_pack(u, e, 1.0, k, block_size=block_size)


def topk_hier_ef_select(u, e, k: int, *, block_size: int = 4096,
                        r: int = 4):
    """Fused hierarchical EF select: candidates -> threshold -> gated
    pack.  At most ``r`` per block, threshold ties may keep slightly more
    than k; exact fused top-k when ``d <= block_size``."""
    return kops.ef_hier_pack(u, e, 1.0, k, block_size=block_size, r=r)


def _fused_as_compress(fused):
    """A fused (u, e, k) -> (vals, idx, resid) selector as a plain
    ``compress(x, k)`` (zero residual input)."""
    @functools.wraps(fused)
    def compress(x, k, **kw):
        vals, idx, _ = fused(x, torch.zeros(x.shape, dtype=torch.float32,
                                            device=x.device), k, **kw)
        return vals, idx
    return compress


def decompress(values: torch.Tensor, indices: torch.Tensor,
               d: int) -> torch.Tensor:
    """Scatter the sparse form back to dense ``(..., d)``.  Scatter-ADD:
    padding entries carry value 0 on clamped indices, a no-op."""
    out = torch.zeros(values.shape[:-1] + (d,), dtype=values.dtype,
                      device=values.device)
    return out.scatter_add_(-1, indices.long(), values)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A named compressor; ``fused_select``, when present, is the
    one-pass kernel ``(u, e, k, **kw) -> (values, indices, residual)``
    that ``lags.local_select_ef`` prefers.  Same contract either way:
    ``e + u == scatter(values, indices) + residual``."""
    name: str
    compress: Callable
    needs_key: bool = False
    fused_select: Callable | None = None

    def __call__(self, x, k, **kw):
        return self.compress(x, k, **kw)


REGISTRY: dict[str, Compressor] = {
    "topk_exact": Compressor("topk_exact", topk_exact_compress),
    "topk_hier": Compressor("topk_hier", topk_hier_compress),
    "topk_hier_kernel": Compressor(
        "topk_hier_kernel",
        functools.partial(topk_hier_compress, use_kernel=True)),
    "topk_block": Compressor("topk_block", topk_block_compress),
    "topk_block_kernel": Compressor(
        "topk_block_kernel",
        functools.partial(topk_block_compress, use_kernel=True)),
    "topk_block_ef_kernel": Compressor(
        "topk_block_ef_kernel", _fused_as_compress(topk_block_ef_select),
        fused_select=topk_block_ef_select),
    "topk_hier_ef_kernel": Compressor(
        "topk_hier_ef_kernel", _fused_as_compress(topk_hier_ef_select),
        fused_select=topk_hier_ef_select),
}

#: names of the reference's compressors this slice has not ported
UNPORTED = ("randk", "topk_sampled")

#: ``selection_backend="kernel"``: compressor name -> kernel variant.
#: ``topk_exact`` maps to the fused hierarchical kernel (exact for leaves
#: with d <= block_size, otherwise a bias that stays in the residual).
KERNEL_BACKED: dict[str, str] = {
    "topk_exact": "topk_hier_ef_kernel",
    "topk_hier": "topk_hier_kernel",
    "topk_block": "topk_block_ef_kernel",
    "topk_hier_kernel": "topk_hier_kernel",
    "topk_block_kernel": "topk_block_kernel",
    "topk_hier_ef_kernel": "topk_hier_ef_kernel",
    "topk_block_ef_kernel": "topk_block_ef_kernel",
}


def kernel_backed(name: str) -> str:
    """The kernel-backed variant of ``name``; raises for compressors
    with none."""
    if name not in KERNEL_BACKED:
        raise ValueError(
            f"compressor {name!r} has no kernel-backed variant "
            f"(selection_backend='kernel' supports {sorted(KERNEL_BACKED)})")
    return KERNEL_BACKED[name]


def get_compressor(name: str) -> Compressor:
    if name in UNPORTED:
        raise NotImplementedError(
            f"compressor {name!r} is not ported yet (ROADMAP.md queue 1 "
            f"item 10: randk, topk_sampled and per-step key threading)")
    if name not in REGISTRY:
        raise KeyError(f"unknown compressor {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
