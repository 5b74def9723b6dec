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
  * ``topk_sampled`` — DGC-style: a threshold estimated from a random
    sample, then an exact top-k over the survivors (approximate).
  * ``randk`` — k distinct indices drawn uniformly (Assumption 1, Eq. 20).

``*_kernel`` / ``*_ef_kernel`` variants run the CUDA kernels of
``repro_torch.kernels``; the ``*_ef_kernel`` ones carry a
``fused_select`` that fuses EF accumulate, selection, payload pack and
residual.  ``KERNEL_BACKED`` maps each name to the variant that
``selection_backend="kernel"`` swaps in; the two sampling compressors
have none, as in the reference.

Random streams.  The reference threads a JAX threefry key through every
key-needing compressor: ``fold_in(PRNGKey(seed), step)`` per step, then
the leaf and the worker folded in.  ``torch.Generator`` cannot reproduce
threefry, so the port names a stream by the same coordinates
(:class:`Key`: the seed and the integers folded into it, in order),
derives one 64-bit seed from them with a fixed integer mix, and draws
with a generator on the tensor's device (:func:`_sample_indices`, the
one place indices are drawn).  The contract: fresh every step, and the
same draw for the same (seed, step, leaf, worker) on the simulation and
the distributed surface of one device type (a CPU and a CUDA generator
give different streams from one seed).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref


_MASK64 = (1 << 64) - 1
# tags a split step of a stream's path apart from a fold-in
_SPLIT_TAG = 0x5EED_5B17_0000_0000


def _mix64(z: int) -> int:
    """SplitMix64's finaliser: a bijection of 64-bit integers."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


@dataclasses.dataclass(frozen=True)
class Key:
    """A random stream named by its coordinates: ``seed`` and the
    integers folded into it, in order (``("split", n, j)`` for the j-th
    of ``split(n)``), the counterpart of a JAX PRNG key."""
    seed: int
    path: tuple = ()

    def fold_in(self, data: int) -> "Key":
        return Key(self.seed, self.path + (int(data),))

    def split(self, n: int) -> list["Key"]:
        return [Key(self.seed, self.path + (("split", int(n), j),))
                for j in range(int(n))]

    def seed64(self) -> int:
        """The stream's seed: one fixed integer mix of the coordinates."""
        h = _mix64(int(self.seed) & _MASK64)
        for x in self.path:
            if isinstance(x, tuple):
                x = _SPLIT_TAG ^ (x[1] << 20) ^ x[2]
            h = _mix64(h ^ (x & _MASK64))
        return h

    def generator(self, device) -> torch.Generator:
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed64() & ((1 << 63) - 1))
        return gen


def _sample_indices(key: Key, d: int, n: int, replace: bool,
                    device) -> torch.Tensor:
    """``n`` indices in [0, d) from ``key``'s stream on ``device``
    (int64): distinct (the head of a random permutation) unless
    ``replace``, else uniform with replacement."""
    gen = key.generator(device)
    if replace:
        return torch.randint(0, d, (n,), generator=gen, device=device)
    return torch.randperm(d, generator=gen, device=device)[:n]


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


def topk_sampled_compress(x: torch.Tensor, k: int, *,
                          sample_frac: float = 0.01, key: Key | None = None):
    """DGC double sampling on a flat ``x`` (d,): the k-th magnitude
    threshold estimated from ``max(int(d·sample_frac), min(d, 256))``
    indices drawn with replacement, entries below it zeroed, then an
    exact top-k of the masked magnitudes (ties, the zeros among them,
    to the lowest index, as ``lax.top_k``)."""
    d = x.shape[-1]
    key = key if key is not None else Key(0)
    n_sample = max(int(d * sample_frac), min(d, 256))
    sample_idx = _sample_indices(key, d, n_sample, True, x.device)
    sample_mag = x[sample_idx].abs()
    k_sample = max(1, int(n_sample * k / d))
    thr = torch.sort(sample_mag, descending=True)[0][k_sample - 1]
    mag = x.abs()
    masked = torch.where(mag >= thr, mag,
                         torch.zeros((), dtype=mag.dtype, device=mag.device))
    idx = ref.topk_order(masked, min(k, d))
    return x[idx], idx.to(torch.int32)


def randk_compress(x: torch.Tensor, k: int, key: Key):
    """``min(k, d)`` distinct indices of a flat ``x`` (d,), drawn
    uniformly from ``key``'s stream, and their values."""
    d = x.shape[-1]
    idx = _sample_indices(key, d, min(k, d), False, x.device)
    return x[idx], idx.to(torch.int32)


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


def sparsify_from(compress_fn, x: torch.Tensor, k: int, **kw) -> torch.Tensor:
    v, i = compress_fn(x, k, **kw)
    return decompress(v, i, x.shape[-1])


def topk_dense(x: torch.Tensor, k: int) -> torch.Tensor:
    """TopK(x, k) of Eq. 4: dense output with d - k zeros."""
    return sparsify_from(topk_exact_compress, x, k)


def randk_dense(x: torch.Tensor, k: int, key: Key) -> torch.Tensor:
    return sparsify_from(randk_compress, x, k, key=key)


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
    # the sampled threshold and randk draw fresh indices every (step,
    # leaf, worker): needs_key threads the per-step stream to them
    "topk_sampled": Compressor("topk_sampled", topk_sampled_compress,
                               needs_key=True),
    "randk": Compressor("randk", randk_compress, needs_key=True),
}

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
    with none (randk, topk_sampled: the sampling is the point, there is
    no selection for a kernel to do)."""
    if name not in KERNEL_BACKED:
        raise ValueError(
            f"compressor {name!r} has no kernel-backed variant "
            f"(selection_backend='kernel' supports {sorted(KERNEL_BACKED)})")
    return KERNEL_BACKED[name]


def get_compressor(name: str) -> Compressor:
    if name not in REGISTRY:
        raise KeyError(f"unknown compressor {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
