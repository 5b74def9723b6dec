"""LAGS-SGD — layer-wise adaptive gradient sparsification (Algorithm 1).

``DenseExchange`` (Dense-SGD baseline), ``LAGSExchange`` (the paper:
per-layer top-k with per-layer error feedback), ``BlockLAGSExchange``
(the same with a per-block budget: the production distributed path) and
``SLGSExchange`` (the single-layer baseline: one global top-k over the
whole-model vector) share the bucket-stream interface of
``repro.core.lags``:

    init(updates_like)                     -> state (residual tree)
    exchange(updates, state, axis_names)   -> (mean_update, new_state)
    exchange_bucket(wave, updates, state, axis_names)
                                           -> (means, new_state)
    launch_bucket(wave, updates, state, axis_names) -> Launched
    Launched.finish()                      -> (means, new_state)

``exchange_bucket`` is ``launch_bucket`` followed by ``finish``: launch
selects and packs, then starts the wave's collectives with
``async_op=True``; finish waits on them and scatter-means.  The split
lets ``repro_torch.pipeline`` start a wave's exchange inside backprop
and wait only after it, so the compute stream never queues behind a
collective.

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

``DenseExchange``, ``BlockLAGSExchange`` and ``SLGSExchange`` serve both
surfaces; ``LAGSExchange`` serves the simulation surface (as in the
reference, where the distributed ``lags_dp`` step builds
``BlockLAGSExchange``).  Not ported yet: the hierarchical exchanges
(ROADMAP.md queue 1 item 9) and tensor parallelism (item 7's tail).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

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


class Launched:
    """An exchange whose collectives may still be in flight.

    ``finish()`` waits on every work handle (on CUDA: makes the current
    stream wait for the collective), then returns ``(means,
    new_state)``; it runs once.  ``keep`` holds the collectives' input
    tensors until then.

    Rule for every ``launch_bucket``: it has read its ``updates`` (and
    its ``state``) by the time it returns — copied them, packed them, or
    enqueued the kernel that reads them on the current stream — and no
    collective or ``finish`` reads them later.  The caller may write to
    them once launch returns: under ``pipeline="async1"`` with momentum
    correction the launched pending updates ARE the velocity tensors,
    which the same step's velocity update then changes in place."""

    def __init__(self, works: Sequence, finish: Callable[[], tuple],
                 keep: tuple = ()):
        self._works, self._finish, self._keep = list(works), finish, keep

    def finish(self) -> tuple:
        if self._finish is None:
            raise RuntimeError("this exchange was already finished")
        for work in self._works:
            work.wait()
        out, self._finish = self._finish(), None
        self._works, self._keep = [], ()
        return out


def _done(means, state) -> Launched:
    """A launch with nothing in flight (the simulation surface)."""
    return Launched((), lambda: (means, state))


def _all_gather_start(x: torch.Tensor, axes: Axes):
    """Start gathering every worker's ``x`` (at least 1-D, contiguous) in
    rank order; returns ((P, ...) output, work).  Gathers into the
    concatenated (P·n, ...) form and views it, because gloo rejects a
    stacked output for ``all_gather_into_tensor``."""
    out = torch.empty((axes.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    work = dist.all_gather_into_tensor(out, x, group=axes.group,
                                       async_op=True)
    return out.reshape((axes.size,) + tuple(x.shape)), work


def _gather_picks_start(vals, idx, axes: Axes):
    """Start the all-gathers of this worker's sparse picks (values and
    indices, the reference's ``_sparse_mean_over``).  Returns (works,
    the gathered inputs to keep alive, every worker's values (P, ...),
    every worker's indices (P, ...))."""
    vals, idx = vals.contiguous(), idx.contiguous()
    vals_all, w_vals = _all_gather_start(vals, axes)
    idx_all, w_idx = _all_gather_start(idx, axes)
    return [w_vals, w_idx], (vals, idx), vals_all, idx_all


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

    def launch_bucket(self, wave, updates, state,
                      axis_names: Axes | None, *, key=None) -> Launched:
        """Distributed: one all-reduce SUM per leaf, started on a copy of
        the update; finish divides by P in place."""
        if axis_names is None:
            return _done([u.mean(0) for u in updates], state)
        sums = [u.clone() for u in updates]
        works = [dist.all_reduce(s, op=dist.ReduceOp.SUM,
                                 group=axis_names.group, async_op=True)
                 for s in sums]
        p = axis_names.size
        return Launched(works, lambda: ([s.div_(p) for s in sums], state))

    def exchange_bucket(self, wave, updates, state,
                        axis_names: Axes | None, *, key=None):
        return self.launch_bucket(wave, updates, state, axis_names).finish()

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

    def launch_bucket(self, wave, updates, state,
                      axis_names: Axes | None, *, key=None) -> Launched:
        return _done(*self.exchange_bucket(wave, updates, state,
                                           axis_names))

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


def _split(vec: torch.Tensor, shapes, dtypes=None) -> list:
    """Cut the last axis of ``vec`` ((..., d)) into consecutive pieces of
    the given shapes (each (...,) + shape's trailing size), as views
    where the layout allows; ``dtypes`` casts each piece."""
    out, off = [], 0
    lead = tuple(vec.shape[:-1])
    for j, shape in enumerate(shapes):
        n = int(math.prod(shape[len(lead):]))
        piece = vec[..., off:off + n].reshape(shape)
        out.append(piece if dtypes is None else piece.to(dtypes[j]))
        off += n
    return out


@dataclasses.dataclass(frozen=True)
class SLGSExchange:
    """Single-layer gradient sparsification baseline: one global top-k
    over the concatenation of ALL leaves (``k_total``), selected only
    after the entire backward pass (``repro.core.lags.SLGSExchange``).

    The updates and the residuals are concatenated separately (the
    accumulate commutes with the concatenation), so a fused compressor
    runs accumulate + select in one pass over the whole-model vector;
    the mean and the residual are split back per leaf."""
    k_total: int
    compressor_name: str = "topk_exact"
    residual_dtype: torch.dtype = torch.float32
    name: str = "slgs"
    compressor_kwargs: tuple = ()
    # global top-k over the whole-model vector: the selection is only
    # defined once every leaf's gradient exists, so the pipeline must
    # schedule exactly one wave
    wave_granularity = "model"

    @property
    def compressor(self) -> C.Compressor:
        return C.get_compressor(self.compressor_name)

    def init(self, updates_like):
        return tree.map(lambda s: torch.zeros(
            tuple(s.shape), dtype=self.residual_dtype, device=s.device),
            updates_like)

    def launch_bucket(self, wave, updates, state,
                      axis_names: Axes | None, *, key=None) -> Launched:
        """The one wave of every leaf, in flatten order: select over the
        whole-model vector, then start the gather of the picks."""
        ids = _wave_ids(wave)
        if ids != tuple(range(len(ids))):
            raise ValueError(
                "slgs selects over the whole-model vector: its single wave "
                "must cover every leaf in flatten order "
                f"(wave_granularity='model'), got leaf_ids={ids}")
        sim = axis_names is None
        w = updates[0].shape[0] if sim else 1
        mean_shapes = [tuple(u.shape[1:] if sim else u.shape)
                       for u in updates]
        dtypes = [u.dtype for u in updates]
        e_shapes = [tuple(e.shape) for e in state]
        u_vec = torch.cat([u.reshape(w, -1) for u in updates], dim=1)
        e_vec = torch.cat([e.reshape(w, -1).float() for e in state], dim=1)
        d = u_vec.shape[1]
        vals, idx, resid_vec = local_select_ef(
            u_vec, e_vec, self.k_total, self.compressor,
            **dict(self.compressor_kwargs))
        del u_vec, e_vec
        resids = _split(resid_vec if sim else resid_vec[0], e_shapes)
        if sim:
            mean = _gathered_scatter_mean(vals, idx, d, w)
            return _done(_split(mean, mean_shapes, dtypes), resids)
        works, keep, vals_all, idx_all = _gather_picks_start(
            vals[0], idx[0], axis_names)
        p = axis_names.size

        def finish():
            mean = _gathered_scatter_mean(vals_all, idx_all, d, p)
            return _split(mean, mean_shapes, dtypes), resids
        return Launched(works, finish, keep)

    def exchange_bucket(self, wave, updates, state,
                        axis_names: Axes | None, *, key=None):
        return self.launch_bucket(wave, updates, state, axis_names).finish()

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

    def _launch_leaf(self, u, e, k: int, axis_names: Axes | None):
        """Select and pack one leaf, then start its gather.  Returns
        (works, kept inputs, finish -> mean, residual)."""
        sim = axis_names is None
        param_shape = tuple(u.shape[1:] if sim else u.shape)
        size = int(math.prod(param_shape))
        n_blocks, bs, k_b = self._geom(size, int(k))
        w = u.shape[0] if sim else 1
        vals, local, resid_rows = self._local_rows(
            u.reshape(w, size), e.reshape(w, size), n_blocks, bs, k_b)
        resid = resid_rows[:, :size].reshape(e.shape)
        dtype = u.dtype

        def mean_of(vals_all, local_all, p):
            mean = _row_scatter_mean(vals_all, local_all, n_blocks, bs,
                                     p)[:size]
            return mean.reshape(param_shape).to(dtype)

        if sim:
            mean = mean_of(vals, local, w)
            return [], (), resid, lambda: mean
        # layer-wise sparse all-gather: 2·k_b scalars per block
        works, keep, vals_all, local_all = _gather_picks_start(
            vals[0], local[0], axis_names)
        p = axis_names.size
        return works, keep, resid, lambda: mean_of(vals_all, local_all, p)

    def launch_bucket(self, wave, updates, state,
                      axis_names: Axes | None, *, key=None) -> Launched:
        """One wave: every leaf selected and packed (the ``ef_select_pack``
        kernel under ``use_kernel``) and its two gathers started."""
        flat_k = tree.leaves(self.ks)
        works, keep, resids, finishes = [], [], [], []
        for i, u, e in zip(_wave_ids(wave), updates, state):
            w, kept, resid, fin = self._launch_leaf(u, e, flat_k[i],
                                                    axis_names)
            works += w
            keep.append(kept)
            resids.append(resid)
            finishes.append(fin)
        return Launched(works, lambda: ([f() for f in finishes], resids),
                        tuple(keep))

    def exchange_bucket(self, wave, updates, state,
                        axis_names: Axes | None, *, key=None):
        """One wave: flat lists of the wave's leaves, global-id keyed.
        Block top-k is deterministic; ``key`` is accepted for interface
        uniformity."""
        return self.launch_bucket(wave, updates, state, axis_names).finish()

    def exchange(self, updates, state, axis_names: Axes | None,
                 *, key=None):
        flat_u, treedef = tree.flatten(updates)
        means, resids = self.exchange_bucket(
            tuple(range(len(flat_u))), flat_u, tree.leaves(state),
            axis_names)
        return tree.unflatten(treedef, means), tree.unflatten(treedef,
                                                              resids)
