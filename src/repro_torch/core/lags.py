"""LAGS-SGD — layer-wise adaptive gradient sparsification (Algorithm 1).

``DenseExchange`` (Dense-SGD baseline), ``LAGSExchange`` (the paper:
per-layer top-k with per-layer error feedback) and ``BlockLAGSExchange``
(the same with a per-block budget: the production distributed path)
share the bucket-stream interface of ``repro.core.lags``:

    init(updates_like)                     -> state (residual tree)
    exchange(updates, state, axis_names)   -> (mean_update, new_state)
    exchange_bucket(wave, updates, state, axis_names)
                                           -> (means, new_state)

``updates`` are learning-rate-scaled gradients.  ``axis_names=None``
selects the simulation surface: leaves carry a leading P axis (one row
per simulated worker).  The distributed surface passes an :class:`Axes`
(the counterpart of the reference's shard_map manual axes: their names
and the ``torch.distributed`` group spanning them); each rank then holds
its own worker's leaves, without the P axis.  ``wave`` is a sequence of
global flatten-order leaf ids (or has ``leaf_ids``).  On the simulation
surface the P workers of a leaf select in one call (one kernel launch,
P·n_blocks rows): rows are independent, so this equals the reference's
per-worker ``vmap``.

``DenseExchange`` and ``BlockLAGSExchange`` serve both surfaces;
``LAGSExchange`` serves the simulation surface (as in the reference,
where the distributed ``lags_dp`` step builds ``BlockLAGSExchange``).
Not ported yet: ``SLGSExchange`` (ROADMAP.md queue 1 item 8), the
hierarchical exchanges (item 9) and tensor parallelism (item 7's tail).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.core import compressors as C
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref


def _size(x) -> int:
    return int(math.prod(x.shape))


def ks_from_ratio(params, ratio: float) -> Any:
    """k^(l) = max(1, round(d^(l) / c)) per leaf (Python's ``round``)."""
    c = float(ratio)
    return tree.map(lambda x: max(1, int(round(_size(x) / c))), params)


def local_select(acc: torch.Tensor, k: int, compressor: C.Compressor, **kw):
    """Per worker: top-k of the accumulated update.  ``acc``: (P, ...).
    Returns (values (P, k'), indices (P, k'), residual (P, ...)) with
    residual = acc - TopK(acc)."""
    flat = acc.reshape(acc.shape[0], -1)
    vals, idx = compressor(flat, k, **kw)
    dense_sel = C.decompress(vals, idx, flat.shape[-1])
    return vals, idx, (flat - dense_sel).reshape(acc.shape)


def local_select_ef(u: torch.Tensor, e: torch.Tensor, k: int,
                    compressor: C.Compressor, **kw):
    """EF accumulate + select for the P workers of one leaf, fused when
    the compressor has a ``fused_select`` kernel (``acc = e + u`` never
    materializes); otherwise ``local_select(e + u, ...)``.  Either way

        e + u == scatter(values, indices) + residual
    """
    if compressor.needs_key:
        raise NotImplementedError(
            "key-needing compressors are not ported yet (ROADMAP.md "
            "queue 1 item 10)")
    if compressor.fused_select is not None:
        p = u.shape[0]
        vals, idx, resid = compressor.fused_select(
            u.reshape(p, -1), e.reshape(p, -1), k, **kw)
        return vals, idx, resid.reshape(e.shape)
    return local_select(e + u.to(e.dtype), k, compressor, **kw)


def _gathered_scatter_mean(vals_all, idx_all, d: int, p) -> torch.Tensor:
    """Sum every worker's sparse contribution into a dense d-vector, / P.

    vals_all, idx_all: (P, ...), one worker per leading row.  The workers
    are scattered one after another in rank order, so each entry sums its
    contributions in (worker, pick) order, as the reference's
    ``.at[idx].add``.  One worker's picks are distinct (a clamped padding
    pick adds 0), so no ``index_add_`` sums duplicates: its CUDA atomics
    then give the same bits on every rank and every run, which keeps the
    distributed replicas equal."""
    dense = torch.zeros((d,), dtype=vals_all.dtype, device=vals_all.device)
    for w in range(vals_all.shape[0]):
        dense.index_add_(0, idx_all[w].reshape(-1), vals_all[w].reshape(-1))
    return dense / p


@dataclasses.dataclass(frozen=True)
class Axes:
    """The distributed surface's worker axes: the names of the mesh axes
    the exchange runs over (the reference's manual ``axis_names``) and
    the ``torch.distributed`` process group spanning them."""
    names: tuple[str, ...]
    group: Any

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)


def all_gather(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Every worker's ``x`` (at least 1-D) stacked in rank order: (P,
    ...).  Gathers into the concatenated (P·n, ...) form and views it,
    because gloo rejects a stacked output for ``all_gather_into_tensor``."""
    x = x.contiguous()
    out = torch.empty((axes.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=axes.group)
    return out.reshape((axes.size,) + tuple(x.shape))


def _psum_mean(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """All-reduce SUM over the worker axes, / P (a new tensor)."""
    s = x.clone()
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=axes.group)
    return s.div_(axes.size)


def _wave_ids(wave) -> tuple[int, ...]:
    ids = getattr(wave, "leaf_ids", wave)
    return tuple(int(i) for i in ids)


def _sim_only(axis_names) -> None:
    if axis_names is not None:
        raise NotImplementedError(
            "LAGSExchange serves the simulation surface only; the "
            "distributed lags_dp step runs BlockLAGSExchange, as in the "
            "reference (pass axis_names=None)")


@dataclasses.dataclass(frozen=True)
class DenseExchange:
    """Vanilla S-SGD: mean of the dense updates over the P workers
    (simulation: over the leading axis; distributed: all-reduce / P)."""
    name: str = "dense"
    wave_granularity = "leaf"

    def init(self, updates_like):
        return ()

    def exchange_bucket(self, wave, updates, state,
                        axis_names: Axes | None, *, key=None):
        if axis_names is None:
            return [u.mean(0) for u in updates], state
        return [_psum_mean(u, axis_names) for u in updates], state

    def exchange(self, updates, state, axis_names: Axes | None,
                 *, key=None):
        flat_u, treedef = tree.flatten(updates)
        means, state = self.exchange_bucket(
            tuple(range(len(flat_u))), flat_u, state, axis_names)
        return tree.unflatten(treedef, means), state


@dataclasses.dataclass(frozen=True)
class LAGSExchange:
    """Layer-wise adaptive gradient sparsification (the paper).

    ``ks``: a tree matching the update tree, of per-leaf k^(l)."""
    ks: Any
    compressor_name: str = "topk_exact"
    residual_dtype: torch.dtype = torch.float32
    name: str = "lags"
    compressor_kwargs: tuple = ()
    wave_granularity = "leaf"

    @property
    def compressor(self) -> C.Compressor:
        return C.get_compressor(self.compressor_name)

    def init(self, updates_like):
        """One residual per simulated worker: leaves (P, ...) of zeros.
        ``updates_like`` leaves need ``shape`` and ``device``."""
        return tree.map(lambda s: torch.zeros(
            tuple(s.shape), dtype=self.residual_dtype, device=s.device),
            updates_like)

    def exchange_bucket(self, wave, updates, state,
                        axis_names: Axes | None, *, key=None):
        """One wave: flat lists of the wave's leaves, global-id keyed."""
        _sim_only(axis_names)
        kw = dict(self.compressor_kwargs)
        comp = self.compressor
        flat_k = tree.leaves(self.ks)
        means, resids = [], []
        for i, u, e in zip(_wave_ids(wave), updates, state):
            p = u.shape[0]
            vals, idx, resid = local_select_ef(u, e, flat_k[i], comp, **kw)
            mean = _gathered_scatter_mean(vals, idx, _size(u[0]), p)
            means.append(mean.reshape(u.shape[1:]))
            resids.append(resid)
        return means, resids

    def exchange(self, updates, state, axis_names: Axes | None,
                 *, key=None):
        flat_u, treedef = tree.flatten(updates)
        means, resids = self.exchange_bucket(
            tuple(range(len(flat_u))), flat_u, tree.leaves(state),
            axis_names)
        return tree.unflatten(treedef, means), tree.unflatten(treedef,
                                                              resids)


# ---------------------------------------------------------------------------
# Block-LAGS: the production distributed path.
# ---------------------------------------------------------------------------

def _row_scatter_mean(vals, local, n_blocks: int, bs: int,
                      p: int) -> torch.Tensor:
    """Scatter-mean P workers' per-block picks on the padded block view.

    vals, local: (P, n_blocks, k_b).  Each row sums its P·k_b picks in
    (worker, pick) order, as the reference's ``.at[row, idx].add``, then
    / P.  Returns the (n_blocks·bs,) padded mean; padding picks (value 0
    on an index past ``d``) land in the padding, which the caller cuts."""
    base = torch.arange(n_blocks, dtype=torch.int64,
                        device=vals.device)[:, None] * bs
    return _gathered_scatter_mean(vals, local + base, n_blocks * bs, p)


@dataclasses.dataclass(frozen=True)
class BlockLAGSExchange:
    """LAGS with the block-budget compressor, keeping the (n_blocks,
    block_size) layout through selection, all-gather and scatter
    (``repro.core.lags.BlockLAGSExchange``).

    Exactly k_b = ceil(k^(l)·bs/d) elements are kept per block (Lemma 1
    with the partition pieces = blocks); the error-feedback residual is
    per leaf, as in ``LAGSExchange``.  ``use_kernel`` runs the fused
    ``ef_select_pack`` kernel (accumulate + select + pack + residual in
    one pass, lr = 1 because updates arrive pre-scaled); otherwise its
    plain version ``ef_select_pack_ref``.  The reference's XLA branch
    selects with masked arg-max passes so that GSPMD can partition it;
    they pick the same entries as the stable sort here (largest
    magnitude, ties to the lowest index).  The reference's
    ``_select_rows`` kernel branch, reached only from outside
    ``_local_rows``, has no caller and no counterpart.

    ``shard_dims``: per-leaf sharded dims (the reference's tensor-
    parallel layout hint, a tree matching ``ks``).  Data parallelism
    only: every leaf's must be empty; the reference's ``row_axes`` pin a
    GSPMD layout and have no counterpart here."""
    ks: Any
    block_size: int = 4096
    residual_dtype: torch.dtype = torch.float32
    name: str = "lags_block"
    use_kernel: bool = False
    shard_dims: Any = None
    wave_granularity = "leaf"

    def __post_init__(self):
        # the per-leaf tuples are containers to tree.leaves, so any leaf
        # left is a sharded dim index
        if self.shard_dims is not None and any(
                d is not None for d in tree.leaves(self.shard_dims)):
            raise NotImplementedError(
                f"BlockLAGSExchange: shard_dims={self.shard_dims!r} needs "
                f"tensor parallelism, not ported yet (ROADMAP.md queue 1 "
                f"item 7, its tensor-parallel tail)")

    def init(self, updates_like):
        return tree.map(lambda s: torch.zeros(
            tuple(s.shape), dtype=self.residual_dtype, device=s.device),
            updates_like)

    def _geom(self, size: int, k: int):
        bs = min(self.block_size, size)
        n_blocks = -(-size // bs)
        # ratio-preserving per-block budget: k_b/bs >= k/d, so k = d
        # keeps every element even when d is not block-divisible
        k_b = max(1, min(bs, -(-k * bs // size)))
        return n_blocks, bs, k_b

    def _local_rows(self, u_flat, e_flat, n_blocks: int, bs: int, k_b: int):
        """Accumulate + select on the padded block view of W workers'
        flat leaves (W, size).  Returns (vals (W, n_blocks, k_b), local
        idx, residual rows (W, n_blocks·bs))."""
        w = u_flat.shape[0]
        select = (kops.ef_select_pack_rows if self.use_kernel
                  else ref.ef_select_pack_ref)
        vals, local, resid = select(kops.block_view(u_flat, n_blocks, bs),
                                    kops.block_view(e_flat, n_blocks, bs),
                                    1.0, None, k_b)
        return (vals.reshape(w, n_blocks, k_b),
                local.reshape(w, n_blocks, k_b), resid.reshape(w, -1))

    def _leaf(self, u, e, k: int, axis_names: Axes | None):
        sim = axis_names is None
        param_shape = tuple(u.shape[1:] if sim else u.shape)
        size = int(math.prod(param_shape))
        n_blocks, bs, k_b = self._geom(size, int(k))
        w = u.shape[0] if sim else 1
        vals, local, resid_rows = self._local_rows(
            u.reshape(w, size), e.reshape(w, size), n_blocks, bs, k_b)
        resid = resid_rows[:, :size]
        if sim:
            p = w
        else:
            # layer-wise sparse all-gather: 2·k_b scalars per block
            p = axis_names.size
            vals, local = all_gather(vals[0], axis_names), \
                all_gather(local[0], axis_names)
        mean = _row_scatter_mean(vals, local, n_blocks, bs, p)[:size]
        return mean.reshape(param_shape).to(u.dtype), resid.reshape(e.shape)

    def exchange_bucket(self, wave, updates, state,
                        axis_names: Axes | None, *, key=None):
        """One wave: flat lists of the wave's leaves, global-id keyed.
        Block top-k is deterministic; ``key`` is accepted for interface
        uniformity."""
        flat_k = tree.leaves(self.ks)
        outs = [self._leaf(u, e, flat_k[i], axis_names)
                for i, u, e in zip(_wave_ids(wave), updates, state)]
        return [o[0] for o in outs], [o[1] for o in outs]

    def exchange(self, updates, state, axis_names: Axes | None,
                 *, key=None):
        flat_u, treedef = tree.flatten(updates)
        means, resids = self.exchange_bucket(
            tuple(range(len(flat_u))), flat_u, tree.leaves(state),
            axis_names)
        return tree.unflatten(treedef, means), tree.unflatten(treedef,
                                                              resids)
