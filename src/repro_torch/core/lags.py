"""LAGS-SGD — layer-wise adaptive gradient sparsification (Algorithm 1).

``DenseExchange`` (Dense-SGD baseline), ``LAGSExchange`` (the paper:
per-layer top-k with per-layer error feedback), ``BlockLAGSExchange``
(the same with a per-block budget: the production distributed path),
``SLGSExchange`` (the single-layer baseline: one global top-k over the
whole-model vector) and the hierarchies ``HierLAGSExchange`` (dense
intra-pod mean, sparse across pods) and ``SparseHierLAGSExchange``
(``lags_hier2``: sparse on both tiers, one residual per tier) share the
bucket-stream interface of ``repro.core.lags``:

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

``key`` (``RunConfig.key_at(step)``, a ``compressors.Key``) feeds the
key-needing compressors (``randk``, ``topk_sampled``), which select
worker by worker: each leaf and worker folds its coordinates into it
(:func:`_leaf_key`, :func:`_worker_keys`) exactly as the reference
folds them into its JAX key, so both surfaces draw the same picks.

``DenseExchange``, ``BlockLAGSExchange``, ``SLGSExchange`` and
``SparseHierLAGSExchange`` serve both surfaces; ``LAGSExchange`` serves
the simulation surface (as in the reference, where the distributed
``lags_dp`` step builds ``BlockLAGSExchange``); ``HierLAGSExchange``
runs on one worker's leaves over its own axes.  Under tensor
parallelism ``BlockLAGSExchange(row_axes=...)`` and ``DenseExchange``
run on each rank's chunks of the leaves.
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


def ks_from_ratios_tree(params, ratios_tree) -> Any:
    """k^(l) = max(1, round(d^(l) / c^(l))) with a per-leaf ratio tree."""
    return tree.map(lambda x, c: max(1, int(round(_size(x) / float(c)))),
                    params, ratios_tree)


# -- per-(step, leaf, worker) random streams of key-needing compressors ----

def _leaf_key(key, leaf_no: int, worker=None) -> C.Key:
    """The stream of one leaf (and one worker): ``key`` (the step's,
    ``RunConfig.key_at``; None = the fixed ``Key(0)``) with the GLOBAL
    leaf index folded in, then ``worker``, the full linear coordinate of
    whoever selects.  The hierarchies fold the (outer, inner) coordinate
    for the intra-pod tier, where each worker selects on its own update,
    but only the pod's for the cross-pod tier, whose accumulator is the
    same on every worker of a pod, so that they draw the same picks."""
    k = (key if key is not None else C.Key(0)).fold_in(leaf_no)
    return k if worker is None else k.fold_in(worker)


def _worker_keys(key, leaf_no: int, p: int, base: int = 0) -> list:
    """The streams of workers ``base .. base + p - 1`` of one leaf on the
    simulation surface: worker w draws what the distributed surface's
    ``_leaf_key(key, leaf_no, w)`` draws."""
    lk = _leaf_key(key, leaf_no)
    return [lk.fold_in(w) for w in range(base, base + p)]


def _worker_index(axes) -> int:
    """This rank's linear worker coordinate over ``axes`` (the rank in
    their group, outer axis major); 0 with no axes."""
    return 0 if axes is None else dist.get_rank(axes.group)


def local_select(acc: torch.Tensor, k: int, compressor: C.Compressor,
                 keys=None, **kw):
    """Per worker: top-k of the accumulated update.  ``acc``: (P, ...).
    Returns (values (P, k'), indices (P, k'), residual (P, ...)) with
    residual = acc - TopK(acc).  A key-needing compressor selects worker
    by worker, worker w with stream ``keys[w]`` (None: ``Key(0)`` for
    every worker, the reference's default)."""
    flat = acc.reshape(acc.shape[0], -1)
    if compressor.needs_key:
        keys = keys if keys is not None else [C.Key(0)] * flat.shape[0]
        picks = [compressor(x, k, key=kk, **kw) for x, kk in zip(flat, keys)]
        vals = torch.stack([v for v, _ in picks])
        idx = torch.stack([i for _, i in picks])
    else:
        vals, idx = compressor(flat, k, **kw)
    dense_sel = C.decompress(vals, idx, flat.shape[-1])
    return vals, idx, (flat - dense_sel).reshape(acc.shape)


def local_select_ef(u: torch.Tensor, e: torch.Tensor, k: int,
                    compressor: C.Compressor, keys=None, **kw):
    """EF accumulate + select for the P workers of one leaf, fused when
    the compressor has a ``fused_select`` kernel (``acc = e + u`` never
    materializes); otherwise ``local_select(e + u, ...)``, with one
    stream per worker (``keys``) for a key-needing compressor.  Either
    way

        e + u == scatter(values, indices) + residual
    """
    if compressor.fused_select is not None and not compressor.needs_key:
        p = u.shape[0]
        vals, idx, resid = compressor.fused_select(
            u.reshape(p, -1), e.reshape(p, -1), k, **kw)
        return vals, idx, resid.reshape(e.shape)
    return local_select(e + u.to(e.dtype), k, compressor, keys=keys, **kw)


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
    the ``torch.distributed`` process group spanning them, its ranks in
    the reference's worker order (outer axis major).  ``parts``: one
    ``Axes`` per name when there are several, so that a tier of an
    exchange can run over some of them (:meth:`sub`)."""
    names: tuple[str, ...]
    group: Any
    parts: tuple = ()

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    def sub(self, names) -> "Axes | None":
        """The axes among these whose names are in ``names`` (None when
        there is none)."""
        keep = tuple(a for a in self.names if a in names)
        if not keep:
            return None
        if keep == self.names:
            return self
        if len(keep) > 1 or len(self.parts) != len(self.names):
            raise NotImplementedError(
                f"axes {keep} of {self.names}: an exchange tier runs over "
                f"one mesh axis or over all of them")
        return self.parts[self.names.index(keep[0])]


class Launched:
    """An exchange whose collectives may still be in flight.

    ``finish()`` waits on every work handle (on CUDA: makes the current
    stream wait for the collective), then returns ``(means,
    new_state)``; it runs once.  ``keep`` holds the collectives' input
    tensors until then.

    Rule for every ``launch_bucket``: it has read its ``updates`` by the
    time it returns — copied them, packed them, or enqueued the kernel
    that reads them on the current stream — and no collective or
    ``finish`` reads them later.  The caller may write to them once
    launch returns: under ``pipeline="async1"`` with momentum correction
    the launched pending updates ARE the velocity tensors, which the
    same step's velocity update then changes in place.  ``finish`` may
    read the launch's ``state`` (the EF residuals), which no caller
    writes between launch and finish: every step takes the new residuals
    from ``finish`` and never writes the old ones.  ``lags_hier2``'s
    outer tier needs this: it selects on the pod mean, which exists only
    once the inner tier's gathers are done, against the outer
    residual."""

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


def _comm_scope(tier: str, kind: str, label: str, nbytes: float, p: int):
    """A ``record_function`` range carrying the ``repro_torch.observe.names``
    grammar (the reference's ``_comm_scope``), so a ``torch.profiler``
    trace attributes each collective per leaf and tier.  Around an
    ``async_op=True`` collective the host range covers its enqueue; on
    CUDA the range's device span covers the collective itself."""
    from repro_torch.observe import names as _obs_names
    from repro_torch.observe.trace import device_annotation
    return device_annotation(
        _obs_names.comm_name(tier, kind, label, nbytes=nbytes, p=p))


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


def _all_gather_flat(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Every rank's flat ``x`` of ``axes``, concatenated in rank order
    (waits for it), under a ``lags/comm/flat/allgather/rows`` range."""
    x = x.contiguous()
    with _comm_scope("flat", "allgather", "rows",
                     x.element_size() * x.numel(), axes.size):
        out, work = _all_gather_start(x, axes)
        work.wait()
    return out.reshape(-1)


def _gather_picks_start(vals, idx, axes: Axes, *, tier: str = "flat",
                        label: str = "leaf"):
    """Start the all-gathers of this worker's sparse picks (values and
    indices, the reference's ``_sparse_mean_over``), both under one
    ``lags/comm/<tier>/allgather/<label>`` range of 8 bytes per pick.
    Returns (works, the gathered inputs to keep alive, every worker's
    values (P, ...), every worker's indices (P, ...))."""
    vals, idx = vals.contiguous(), idx.contiguous()
    with _comm_scope(tier, "allgather", label, 8.0 * vals.numel(),
                     axes.size):
        vals_all, w_vals = _all_gather_start(vals, axes)
        idx_all, w_idx = _all_gather_start(idx, axes)
    return [w_vals, w_idx], (vals, idx), vals_all, idx_all


def _sparse_mean_start(vals, idx, d: int, axes: Axes | None, *,
                       tier: str = "flat", label: str = "leaf"):
    """Start the mean of one worker's sparse picks (vals, idx: (k,)) over
    ``axes`` (the reference's ``_sparse_mean_over``, ``tier``/``label``
    naming its trace range): returns (works, kept inputs, finish -> the
    dense (d,) mean).  ``axes=None`` is the single worker: its picks
    decompressed."""
    if axes is None:
        return [], (), lambda: C.decompress(vals, idx, d)
    works, keep, vals_all, idx_all = _gather_picks_start(
        vals, idx, axes, tier=tier, label=label)
    p = axes.size
    return works, keep, lambda: _gathered_scatter_mean(vals_all, idx_all,
                                                       d, p)


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
        # NCCL takes contiguous buffers only; a gradient may come strided
        sums = [u.clone(memory_format=torch.contiguous_format)
                for u in updates]
        p = axis_names.size
        works = []
        for i, s in zip(_wave_ids(wave), sums):
            with _comm_scope("flat", "allreduce", f"l{i}", 4.0 * s.numel(),
                             p):
                works.append(dist.all_reduce(s, op=dist.ReduceOp.SUM,
                                             group=axis_names.group,
                                             async_op=True))
        return Launched(works, lambda: ([s.div_(p) for s in sums], state))

    def exchange_bucket(self, wave, updates, state,
                        axis_names: Axes | None, *, key=None):
        return self.launch_bucket(wave, updates, state, axis_names,
                                  key=key).finish()

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
                                           axis_names, key=key))

    def exchange_bucket(self, wave, updates, state,
                        axis_names: Axes | None, *, key=None):
        """One wave: flat lists of the wave's leaves, global-id keyed
        (the leaf's stream too)."""
        _sim_only(axis_names)
        kw = dict(self.compressor_kwargs)
        comp = self.compressor
        flat_k = tree.leaves(self.ks)
        means, resids = [], []
        for i, u, e in zip(_wave_ids(wave), updates, state):
            p = u.shape[0]
            keys = _worker_keys(key, i, p) if comp.needs_key else None
            vals, idx, resid = local_select_ef(u, e, flat_k[i], comp,
                                               keys=keys, **kw)
            mean = _gathered_scatter_mean(vals, idx, _size(u[0]), p)
            means.append(mean.reshape(u.shape[1:]))
            resids.append(resid)
        return means, resids

    def exchange(self, updates, state, axis_names: Axes | None,
                 *, key=None):
        flat_u, treedef = tree.flatten(updates)
        means, resids = self.exchange_bucket(
            tuple(range(len(flat_u))), flat_u, tree.leaves(state),
            axis_names, key=key)
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
        comp = self.compressor
        keys = None
        if comp.needs_key:      # the one "leaf" is the packed vector, id 0
            keys = (_worker_keys(key, 0, w) if sim
                    else [_leaf_key(key, 0, _worker_index(axis_names))])
        vals, idx, resid_vec = local_select_ef(
            u_vec, e_vec, self.k_total, comp, keys=keys,
            **dict(self.compressor_kwargs))
        del u_vec, e_vec
        resids = _split(resid_vec if sim else resid_vec[0], e_shapes)
        if sim:
            mean = _gathered_scatter_mean(vals, idx, d, w)
            return _done(_split(mean, mean_shapes, dtypes), resids)
        works, keep, mean_of = _sparse_mean_start(vals[0], idx[0], d,
                                                  axis_names, label="packed")
        return Launched(works, lambda: (
            _split(mean_of(), mean_shapes, dtypes), resids), keep)

    def exchange_bucket(self, wave, updates, state,
                        axis_names: Axes | None, *, key=None):
        return self.launch_bucket(wave, updates, state, axis_names,
                                  key=key).finish()

    def exchange(self, updates, state, axis_names: Axes | None,
                 *, key=None):
        flat_u, treedef = tree.flatten(updates)
        means, resids = self.exchange_bucket(
            tuple(range(len(flat_u))), flat_u, tree.leaves(state),
            axis_names, key=key)
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

    ``shard_dims``: per-leaf tuples of sharded dims, a tree matching
    ``ks`` (the reference's layout hint; () or None = unsharded).  The
    block view lays a leaf's sharded dims first before it flattens, as
    the reference's does so that each device's rows stay local; this
    decides which entries share a block.  ``lags_hier`` passes its FSDP
    dim over 'data', whose parameters stay replicated here.

    ``row_axes``: the 'model' axis (an :class:`Axes`) whose ranks each
    hold one chunk of every leaf with a sharded dim (tensor
    parallelism: ``u`` and ``e`` are this rank's chunks, the sharded dim
    the one in ``shard_dims``).  Laid first, that dim makes the chunk of
    rank m the segment [m·L, (m+1)·L) of the full leaf's flat block view
    (L its size), and the budget and blocks are the full leaf's.  When L
    and m·L fall on block boundaries, rank m selects, gathers and
    scatters its own L/bs block rows, the rows the reference pins to it;
    otherwise the blocks that cover its segment straddle a neighbour's,
    and the chunks are first all-gathered over ``row_axes`` so that those
    blocks select what the reference's select.  A leaf without a sharded
    dim is whole on every rank, which runs all of its rows."""
    ks: Any
    block_size: int = 4096
    residual_dtype: torch.dtype = torch.float32
    name: str = "lags_block"
    use_kernel: bool = False
    shard_dims: Any = None
    row_axes: Axes | None = None
    wave_granularity = "leaf"

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
        g_rows = kops.block_view(u_flat, n_blocks, bs)
        e_rows = kops.block_view(e_flat, n_blocks, bs)
        if k_b == bs:      # every entry kept (a leaf planned dense)
            vals, local, resid = kops.keep_all_rows(g_rows, e_rows, 1.0)
        else:
            select = (kops.ef_select_pack_rows if self.use_kernel
                      else ref.ef_select_pack_ref)
            vals, local, resid = select(g_rows, e_rows, 1.0, None, k_b)
        return (vals.reshape(w, n_blocks, k_b),
                local.reshape(w, n_blocks, k_b), resid.reshape(w, -1))

    def _launch_leaf(self, u, e, k: int, sdims, axis_names: Axes | None):
        """Select and pack one leaf, then start its gather.  Returns
        (works, kept inputs, finish -> mean, residual)."""
        sim = axis_names is None
        param_shape = tuple(u.shape[1:] if sim else u.shape)
        n_local = int(math.prod(param_shape))
        w = u.shape[0] if sim else 1
        lead = len(u.shape) - len(param_shape)
        sd = tuple(d for d in (sdims or ()) if 0 <= d < len(param_shape))
        perm = (sd + tuple(i for i in range(len(param_shape))
                           if i not in sd)) if sd else None
        tp = m = 0
        if self.row_axes is not None and sd and not sim:
            tp, m = self.row_axes.size, dist.get_rank(self.row_axes.group)
        # the full leaf's geometry; this rank's segment [lo, lo + n_local)
        # of its flat view and the block rows [r_lo, r_hi) that cover it
        size = n_local * max(tp, 1)
        n_blocks, bs, k_b = self._geom(size, int(k))
        lo = m * n_local
        r_lo, r_hi = lo // bs, min(n_blocks, -(-(lo + n_local) // bs))
        off, end = lo - r_lo * bs, min(r_hi * bs, size) - r_lo * bs

        def to_flat(x):
            if perm is not None:      # the sharded dims first
                x = x.permute(tuple(range(lead))
                              + tuple(lead + i for i in perm))
            x = x.reshape(w, n_local)
            if off == 0 and end == n_local:
                return x
            # blocks straddle a neighbour's chunk: the covering rows
            full = _all_gather_flat(x[0], self.row_axes)
            return full[r_lo * bs:r_lo * bs + end][None]

        def from_flat(flat, shape_lead):
            flat = flat[..., off:off + n_local]
            if perm is None:
                return flat.reshape(shape_lead + param_shape)
            n = len(shape_lead)
            inv = sorted(range(len(perm)), key=perm.__getitem__)
            x = flat.reshape(shape_lead + tuple(param_shape[i] for i in perm))
            return x.permute(tuple(range(n))
                             + tuple(n + i for i in inv)).contiguous()

        n_rows = r_hi - r_lo
        vals, local, resid_rows = self._local_rows(
            to_flat(u), to_flat(e), n_rows, bs, k_b)
        resid = from_flat(resid_rows, tuple(e.shape[:lead])).reshape(e.shape)
        dtype = u.dtype

        def mean_of(vals_all, local_all, p):
            mean = _row_scatter_mean(vals_all, local_all, n_rows, bs, p)
            return from_flat(mean, ()).to(dtype)

        if sim:
            mean = mean_of(vals, local, w)
            return [], (), resid, lambda: mean
        # layer-wise sparse all-gather: 2·k_b scalars per block
        works, keep, vals_all, local_all = _gather_picks_start(
            vals[0], local[0], axis_names, label="blocks")
        p = axis_names.size
        return works, keep, resid, lambda: mean_of(vals_all, local_all, p)

    def launch_bucket(self, wave, updates, state,
                      axis_names: Axes | None, *, key=None) -> Launched:
        """One wave: every leaf selected and packed (the ``ef_select_pack``
        kernel under ``use_kernel``) and its two gathers started."""
        flat_k, treedef = tree.flatten(self.ks)
        flat_s = (tree.flatten_up_to(treedef, self.shard_dims)
                  if self.shard_dims is not None else [None] * len(flat_k))
        works, keep, resids, finishes = [], [], [], []
        for i, u, e in zip(_wave_ids(wave), updates, state):
            w, kept, resid, fin = self._launch_leaf(u, e, flat_k[i],
                                                    flat_s[i], axis_names)
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
        return self.launch_bucket(wave, updates, state, axis_names,
                                  key=key).finish()

    def exchange(self, updates, state, axis_names: Axes | None,
                 *, key=None):
        flat_u, treedef = tree.flatten(updates)
        means, resids = self.exchange_bucket(
            tuple(range(len(flat_u))), flat_u, tree.leaves(state),
            axis_names, key=key)
        return tree.unflatten(treedef, means), tree.unflatten(treedef,
                                                              resids)


# ---------------------------------------------------------------------------
# The hierarchies (beyond the paper, multi-pod): Lemma 1 holds for any
# partition of the gradient into pieces, at each tier.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HierLAGSExchange:
    """Hierarchical LAGS with a dense inner tier
    (``repro.core.lags.HierLAGSExchange``): one worker's update is
    averaged densely over ``inner_axes`` (the fast links), then selected
    with error feedback and sparse-meaned over ``outer_axes`` (the slow
    ones).

    Leaves are one worker's, without a P axis; the exchange runs over
    its own axes (``axis_names`` is ignored, as in the reference): each
    an :class:`Axes` or None/``()`` for none.  With no axes it is a
    local top-k.  The inner mean is what the selection reads, so a
    launch waits for it; only the outer gathers are in flight after
    it."""
    ks: Any
    inner_axes: Any = None
    outer_axes: Any = None
    compressor_name: str = "topk_exact"
    residual_dtype: torch.dtype = torch.float32
    name: str = "lags_hier"
    compressor_kwargs: tuple = ()
    wave_granularity = "leaf"

    @property
    def compressor(self) -> C.Compressor:
        return C.get_compressor(self.compressor_name)

    def init(self, updates_like):
        return tree.map(lambda s: torch.zeros(
            tuple(s.shape), dtype=self.residual_dtype, device=s.device),
            updates_like)

    def launch_bucket(self, wave, updates, state, axis_names=None, *,
                      key=None) -> Launched:
        kw = dict(self.compressor_kwargs)
        comp = self.compressor
        flat_k = tree.leaves(self.ks)
        inner, outer = self.inner_axes or None, self.outer_axes or None
        works, keep, resids, finishes = [], [], [], []
        for i, u, e in zip(_wave_ids(wave), updates, state):
            if inner is not None:     # the reference's _psum_mean
                s = u.clone(memory_format=torch.contiguous_format)
                with _comm_scope("inner", "allreduce", f"l{i}",
                                 4.0 * s.numel(), inner.size):
                    dist.all_reduce(s, op=dist.ReduceOp.SUM,
                                    group=inner.group)
                u = s.div_(inner.size)
            # the dense inner mean is the same on every worker of the
            # pod: the stream folds only the pod's coordinate
            keys = ([_leaf_key(key, i, _worker_index(outer))]
                    if comp.needs_key else None)
            vals, idx, resid = local_select_ef(u[None], e[None], flat_k[i],
                                               comp, keys=keys, **kw)
            w, kept, fin = _sparse_mean_start(vals[0], idx[0], u.numel(),
                                              outer, tier="outer",
                                              label=f"l{i}")
            works += w
            keep.append(kept)
            resids.append(resid[0])
            finishes.append((fin, u.shape, u.dtype))
        return Launched(works, lambda: (
            [f().reshape(shape).to(dtype) for f, shape, dtype in finishes],
            resids), tuple(keep))

    def exchange_bucket(self, wave, updates, state, axis_names=None, *,
                        key=None):
        return self.launch_bucket(wave, updates, state, axis_names,
                                  key=key).finish()

    def exchange(self, updates, state, axis_names=None, *, key=None):
        flat_u, treedef = tree.flatten(updates)
        means, resids = self.exchange_bucket(
            tuple(range(len(flat_u))), flat_u, tree.leaves(state),
            axis_names, key=key)
        return tree.unflatten(treedef, means), tree.unflatten(treedef,
                                                              resids)


@dataclasses.dataclass(frozen=True)
class SparseHierLAGSExchange:
    """Sparse-intra-pod hierarchical LAGS (``lags_hier2``,
    ``repro.core.lags.SparseHierLAGSExchange``).

    Per leaf, per step:

      1. inner tier: each worker accumulates its inner residual
         (``acc_in = e_in + u``), selects ``ks_inner`` entries, and the
         selections are scatter-meaned within the pod;
      2. outer tier: the pod mean ``m`` lands on a second accumulator
         (``acc_out = e_out + m``, the same on every worker of the pod),
         ``ks`` entries are selected and scatter-meaned across pods.

    Per-tier invariant: ``acc == scatter(values, indices) + residual``.
    State is ``{"inner": tree, "outer": tree}`` in the per-worker layout;
    the outer residual is replicated across the workers of a pod (same
    data, deterministic selection), which keeps the distributed and the
    simulation path bit for bit equal.

    Simulation (``axis_names=None``): the leading P axis factors as
    (n_outer, n_inner), outer-major.  Distributed: ``outer_axis`` of the
    :class:`Axes` carries the cross-pod tier, every other axis the
    intra-pod one; the inner picks' gathers start at launch, and
    ``finish`` waits for them, selects the outer tier (reading the outer
    residual, see :class:`Launched`) and runs the cross-pod gathers."""
    ks: Any                        # outer-tier per-leaf k (cross-pod)
    ks_inner: Any                  # inner-tier per-leaf k (intra-pod)
    n_inner: int = 1               # leading-P factorization (simulation)
    outer_axis: str = "pod"
    compressor_name: str = "topk_exact"
    residual_dtype: torch.dtype = torch.float32
    name: str = "lags_hier2"
    compressor_kwargs: tuple = ()
    # inner-tier compressor override (None = compressor_name)
    inner_compressor_name: str | None = None
    inner_compressor_kwargs: tuple = ()
    wave_granularity = "leaf"

    @property
    def compressor(self) -> C.Compressor:
        return C.get_compressor(self.compressor_name)

    @property
    def inner_compressor(self) -> C.Compressor:
        return C.get_compressor(self.inner_compressor_name
                                or self.compressor_name)

    def init(self, updates_like):
        def zeros():
            return tree.map(lambda s: torch.zeros(
                tuple(s.shape), dtype=self.residual_dtype, device=s.device),
                updates_like)
        return {"inner": zeros(), "outer": zeros()}

    def _tiers(self):
        """((inner compressor, kwargs), (outer compressor, kwargs))."""
        kw = dict(self.compressor_kwargs)
        ikw = (dict(self.inner_compressor_kwargs)
               if self.inner_compressor_name else kw)
        return (self.inner_compressor, ikw), (self.compressor, kw)

    def _sim_leaf(self, i, u, e_in, e_out, k_in, k_out, key):
        (icomp, ikw), (comp, kw) = self._tiers()
        p = u.shape[0]
        n_in = max(1, int(self.n_inner))
        if p % n_in:
            raise ValueError(f"P={p} workers do not factor into n_inner="
                             f"{n_in} per pod (leaf {i})")
        n_out = p // n_in
        d = _size(u[0])
        # inner tier: each worker's own stream (the full coordinate)
        keys = _worker_keys(key, i, p) if icomp.needs_key else None
        vals, idx, resid_in = local_select_ef(u, e_in, k_in, icomp,
                                              keys=keys, **ikw)
        # the pod means, each pod's workers scattered in rank order
        m = torch.empty((n_out, d), dtype=vals.dtype, device=vals.device)
        for o in range(n_out):
            pod = slice(o * n_in, (o + 1) * n_in)
            m[o] = _gathered_scatter_mean(vals[pod], idx[pod], d, n_in)
        del vals, idx
        # one outer accumulator per pod: the pod's first copy of e_out
        lead = (n_out, n_in) + tuple(e_out.shape[1:])
        e_pod = e_out.reshape(lead)[:, 0].contiguous()
        # outer tier: pod o's stream; past the inner workers' (p + o)
        # when the inner tier is sparse, so that the tiers draw apart,
        # and LAGSExchange's over the pods (o) when it is dense
        keys = (_worker_keys(key, i, n_out, 0 if int(k_in) >= d else p)
                if comp.needs_key else None)
        vals2, idx2, resid_out = local_select_ef(
            m.reshape((n_out,) + tuple(u.shape[1:])), e_pod, k_out, comp,
            keys=keys, **kw)
        del m, e_pod
        mean = _gathered_scatter_mean(vals2, idx2, d, n_out)
        resid_out = resid_out[:, None].expand(lead).reshape(e_out.shape)
        return mean.reshape(u.shape[1:]).to(u.dtype), resid_in, resid_out

    def launch_bucket(self, wave, updates, state,
                      axis_names: Axes | None, *, key=None) -> Launched:
        """One wave; ``state`` is ``{"inner": [...], "outer": [...]}``,
        flat lists of the wave's residual leaves of each tier."""
        ids = _wave_ids(wave)
        ks_in, ks_out = tree.leaves(self.ks_inner), tree.leaves(self.ks)
        legs = zip(ids, updates, state["inner"], state["outer"])
        if axis_names is None:
            out = [self._sim_leaf(i, u, ei, eo, ks_in[i], ks_out[i], key)
                   for i, u, ei, eo in legs]
            return _done([o[0] for o in out],
                         {"inner": [o[1] for o in out],
                          "outer": [o[2] for o in out]})
        (icomp, ikw), (comp, kw) = self._tiers()
        inner = axis_names.sub(tuple(a for a in axis_names.names
                                     if a != self.outer_axis))
        outer = axis_names.sub((self.outer_axis,))
        me, p = _worker_index(axis_names), axis_names.size
        pod = _worker_index(outer)
        works, keep, legs_in = [], [], []
        for i, u, e_in, e_out in legs:
            keys = ([_leaf_key(key, i, me)] if icomp.needs_key else None)
            vals, idx, resid_in = local_select_ef(u[None], e_in[None],
                                                  ks_in[i], icomp, keys=keys,
                                                  **ikw)
            w, kept, m_of = _sparse_mean_start(vals[0], idx[0], u.numel(),
                                               inner, tier="inner",
                                               label=f"l{i}")
            works += w
            keep.append(kept)
            legs_in.append((i, u.shape, u.dtype, e_out, resid_in[0], m_of))

        def finish():
            # the outer tier: select on the pod mean, then the cross-pod
            # gathers of every leaf, then their scatter-means
            works2, keep2, outs = [], [], []
            for i, shape, dtype, e_out, resid_in, m_of in legs_in:
                m = m_of().reshape((1,) + tuple(shape))
                # the pod's stream, shifted as on the simulation path
                base = 0 if int(ks_in[i]) >= e_out.numel() else p
                keys = ([_leaf_key(key, i, base + pod)] if comp.needs_key
                        else None)
                vals2, idx2, resid_out = local_select_ef(
                    m, e_out[None], ks_out[i], comp, keys=keys, **kw)
                del m
                w, kept, mean_of = _sparse_mean_start(
                    vals2[0], idx2[0], e_out.numel(), outer, tier="outer",
                    label=f"l{i}")
                works2 += w
                keep2.append(kept)
                outs.append((mean_of, shape, dtype, resid_in, resid_out[0]))
            legs_in.clear()
            for work in works2:
                work.wait()
            return ([f().reshape(shape).to(dtype)
                     for f, shape, dtype, _, _ in outs],
                    {"inner": [o[3] for o in outs],
                     "outer": [o[4] for o in outs]})
        return Launched(works, finish, tuple(keep))

    def exchange_bucket(self, wave, updates, state,
                        axis_names: Axes | None, *, key=None):
        return self.launch_bucket(wave, updates, state, axis_names,
                                  key=key).finish()

    def exchange(self, updates, state, axis_names: Axes | None,
                 *, key=None):
        flat_u, treedef = tree.flatten(updates)
        means, ns = self.exchange_bucket(
            tuple(range(len(flat_u))), flat_u,
            {"inner": tree.leaves(state["inner"]),
             "outer": tree.leaves(state["outer"])}, axis_names, key=key)
        return (tree.unflatten(treedef, means),
                {"inner": tree.unflatten(treedef, ns["inner"]),
                 "outer": tree.unflatten(treedef, ns["outer"])})
