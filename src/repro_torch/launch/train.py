"""Distributed data-parallel train step: the counterpart of
``repro.launch.train``.

Build steps through ``repro_torch.api`` (``Session(cfg, run,
mesh=...).train_step()`` or ``build_train_step(cfg, mesh, run)``).  One
process per rank; each runs the step on its own rank, as the
reference's shard_map ``worker`` runs on its manual-axis shard:

  1. the gradient of the loss on this rank's rows of the global batch
     (rank r of the data axes takes rows [r·B/R, (r+1)·B/R) of R ranks,
     pod-major: the simulation surface's split), each MoE layer
     dispatching the reference's token groups (one, or under
     ``pod_auto`` those of ``pod_auto_moe_groups``), and each period of
     the stack recomputed in the backward (``loss_fn``'s ``remat``);
  2. ``u = lr·g`` in f32; under the ``pod_auto`` axis plan (``lags_hier``)
     the dense mean of ``u`` over the pod's ranks (the 'data' axis), the
     reference's per-pod gradient; the DGC velocity ``mom = mc·mom + u``
     when ``momentum_correction`` mc > 0;
  3. the exchange over the strategy's worker axes: ``dense`` all-reduces
     the mean, ``lags_dp`` runs ``BlockLAGSExchange`` (per-block top-k
     with error feedback, the sparse (values, indices) all-gathered leaf
     by leaf) and ``slgs`` one global top-k over the whole-model vector,
     each over every rank of ('pod', 'data'); ``lags_hier2`` runs
     ``SparseHierLAGSExchange`` over the same ranks, sparse within each
     pod and then across pods; ``lags_hier`` runs ``BlockLAGSExchange``
     over 'pod' (one worker per pod; on a single-pod mesh its
     simulation path with P = 1, as the reference runs it);
  4. ``p <- (f32(p) − mean).to(p.dtype)``: plain SGD on pre-scaled
     deltas (Algorithm 1 line 10), not ``optim.SGD``.

``run.pipeline`` says when step 3 runs (``repro_torch.pipeline``):
``"off"`` after backward; ``"wave"`` inside backprop, each wave of leaves
launched by autograd hooks as its gradients land and finished after
backward (bitwise equal to ``"off"``; ``lags_hier`` runs its waves after
backward, as the reference's pure-auto path does: its update needs the
pod's mean first); ``"async1"`` exchanges the PREVIOUS step's updates
(``state["pending"]``, zeros at step 0): launched before the forward,
finished after the backward, while this step's updates (the velocity
under mc) become the new pending — one step of bounded staleness.

The loss is all-reduce-averaged over every data rank.  State: ``{"params",
"ef", "step"}``, plus ``"extra": {"mom"}`` when mc > 0 and ``"pending"``
under ``async1``.  ``ef`` (one tree per tier, ``{"inner", "outer"}``, for
``lags_hier2``), ``mom`` and ``pending`` hold this rank's worker slice,
leaves (1, ...) f32 (the reference's per-worker state under its manual
axes; under ``lags_hier`` the pod's, the same on each of its ranks);
``step`` is a Python int.  The port updates the parameters and the
velocity in place, which saves one copy of each; under ``async1`` with
mc the pending leaves are the velocity's own.  ``lags_hier`` shards
the parameters over 'data' (FSDP, the reference's ``param_pspecs(...,
"lags_hier")``) on every mesh: without a 'model' axis each is a
``DTensor`` on the pod's 'data' sub-mesh, ``ef``, ``mom`` and
``pending`` hold its block, and the step runs as under tensor
parallelism's FSDP below (``DataShards``, ``_WholeLeaves`` over 'data').

Tensor parallelism (a mesh with a 'model' axis, ``make_mesh(model=)``,
beside 'data' and optionally 'pod'; the reference's GSPMD auto axis):
the parameters are ``DTensor``s over 'model', laid out by
``param_pspecs`` (``sharding.dtensor``), and stay plain replicas over
the data axes, so each data rank takes its own gradient as above.  A
rank takes its (pod, data) coordinate's rows (every 'model' rank of one
coordinate the same); the forward and backward run under
``implicit_replication``; each gradient is reduced to its parameter's
placements (``dtensor.grad_to_local``, inside the hooks under ``wave``)
before ``u`` is formed; the worker axes are the data axes' ranks of this
rank's model index (``mesh.worker_axes``); ``ef``, ``mom`` and
``pending`` hold this rank's chunk, ``(1, *chunk)`` f32; the update is
applied in place to the chunk; the loss is averaged over the data ranks.
By mode:

  * ``dense`` and ``lags_dp`` exchange each rank's chunk rows
    (``BlockLAGSExchange(row_axes=)``, ``shard_dims`` over 'model');
  * ``slgs`` and ``lags_hier2`` select on whole leaves, as the
    reference's factories (which take no ``shard_dims``) do under GSPMD:
    each update and residual chunk is gathered over 'model' to its full
    leaf, the unchanged exchange runs over the data workers, and each
    rank keeps its chunk of the mean and of each residual
    (``_WholeLeaves``: a leaf at a time, ``slgs`` the whole model at
    once; every 'model' rank selects the same entries);
  * ``lags_hier`` shards the parameters over 'data' too (FSDP, the
    reference's ``param_pspecs(..., "lags_hier")``): each is a
    ``DTensor`` on the pod's ('data', 'model') sub-mesh, and ``ef``,
    ``mom`` and ``pending`` hold its 2-D block.  Each leaf is gathered
    over 'data' outside autograd before the forward, and each update
    reduce-scattered over 'data' after the backward (``DataShards``);
    the exchange gathers the update and the residual over the pod's
    ('data', 'model') ranks a leaf at a time and runs the block exchange
    over 'pod' on the full leaf with the reference's two-dim
    ``shard_dims`` (('data', 'model') in that order).

It covers every family (``check_tensor_parallel``): the dense decoders,
the encoder-decoder and the VLM on DTensor propagation; the MoE layer
(each rank its part of the experts, in the F or the E layout:
``models.moe``), the mLSTM, sLSTM and Mamba layers (each rank its heads
or channels: ``models.xlstm``, ``models.ssm``) on local tensors between
the explicit 'model' boundaries of ``models.tp``.  Under ``lags_hier``
an MoE token group that spans a pod's ranks (``pod_auto_moe_groups``)
is gathered over the pod's 'data' ranks (``models.moe.TokenSpan``) on
a mesh without a 'model' axis, and raises on one with it.

``run.schedule`` (an autotuned ``Schedule``/``HierSchedule``) replaces
the scalar ratio's per-leaf budgets, through
``registry.resolve_schedule_ks`` (``validate_for`` first, the
simulation surface's path).  Each exchange gets the step's stream
``run.key_at(step)`` (under ``async1`` the previous step's, whose
updates it exchanges), as the reference's.

``run.health_every > 0`` adds the convergence-health quantities of
``repro_torch.observe.health`` to every step's metrics, as the
reference's step computes them (modes with per-leaf budgets: not
``dense`` or ``slgs``): ``health_delta`` per leaf and
``health_delta_max`` (for ``lags_hier2`` the outer tier's), the EF
energy retention (``health_ef_energy_flat``, or ``_inner``/``_outer``;
under ``wave``, whose hooks consume the updates inside backprop, the
aggregate form and no inner tier) and under ``async1``
``health_staleness``.  The delta's numerator ``||sum_w e_new||^2`` costs
one dense all-reduce per leaf over the workers (cross terms are not
recoverable from per-worker scalars), each under a
``lags/comm/<tier>/allreduce/health/l<i>`` range; the sums of squares
are one all-reduce of L floats each.  Where the parameters are
``DTensor``s each rank's residuals, means and updates are chunks, so
every per-leaf sum of squares takes one more all-reduce of its (2, L)
floats over each axis of the parameters' sub-mesh ('model', and 'data'
under ``lags_hier``), a replicated chunk counted by one rank of it; no
leaf is gathered, and Eq. 20's ``1 - k/d`` takes the full leaf's d and
k.  ``health_every == 0`` adds no key and no work.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.api import registry as R
from repro_torch.api.config import RunConfig, canonical_mode
from repro_torch.core import lags
from repro_torch.launch import mesh as M
from repro_torch.models import moe as MO
from repro_torch.models import transformer as T
from repro_torch.observe import health as H
from repro_torch.pipeline import buckets as WB
from repro_torch.pipeline import step as WS
from repro_torch.pipeline import waves as WW
from repro_torch.sharding import dtensor as D
from repro_torch.sharding import rules
from repro_torch.training.train_loop import Spec

#: the model families a mesh with a 'model' axis trains
TP_FAMILIES = ("dense", "moe", "audio", "vlm", "ssm", "hybrid")
#: what it does not run yet: an MoE token group that spans a pod's ranks
#: on a mesh with a 'model' axis
TP_NEXT_FAMILIES = ("ROADMAP.md queue 1 item 7e's third part, the "
                    "tensor-parallel part for an MoE token group across a "
                    "pod's ranks on a 'model' axis")
#: the modes a mesh with a 'model' axis runs
TP_MODES = ("dense", "lags_dp", "slgs", "lags_hier2", "lags_hier")
#: ... of which these exchange each rank's chunk rows; the others gather
#: whole leaves (``_WholeLeaves``)
TP_CHUNK_MODES = ("dense", "lags_dp")


def _mode(cfg, mesh, method: str | None):
    """(mode, manual axes, worker axes) from the strategy's axis plan
    (``ExchangeStrategy.axes``): ``data_manual`` strategies run over the
    data axes ('pod', 'data'), every rank a worker; ``pod_auto``
    (lags_hier) has one worker per pod, over 'pod' (no axis on a
    single-pod mesh), and no manual axes; ``none`` has neither.  Unknown
    modes raise."""
    mode = canonical_mode(method or cfg.train_mode)
    plan = R.get_exchange(mode).axes
    if plan == "pod_auto":
        return mode, (), tuple(a for a in mesh.mesh_dim_names if a == "pod")
    if plan == "data_manual":
        manual = M.data_axis_names(mesh)
        return mode, manual, manual
    return mode, (), ()


def _tp_priority(cfg):
    """The tensor-parallel priority of ``cfg`` (its ``moe_shard``)."""
    if getattr(cfg, "moe_shard", "ffn") == "experts":
        return rules.TP_PRIORITY_EXPERTS
    return rules.TP_PRIORITY


def param_pspecs(cfg, mesh, mode: str, params_like=None):
    """Each parameter's spec on ``mesh`` (the reference's
    ``param_pspecs``): 'model' by the config's tensor-parallel priority,
    and under ``lags_hier`` FSDP over 'data'."""
    if params_like is None:
        params_like = T.abstract_params(cfg)
    return rules.tree_specs(params_like, T.logical_axes(cfg),
                            rules.mesh_axis_sizes(mesh), tp_axis="model",
                            fsdp_axis="data" if mode == "lags_hier" else None,
                            tp_priority=_tp_priority(cfg))


def check_tensor_parallel(cfg, mesh, mode: str):
    """Raise for what a mesh with a 'model' axis does not run: modes
    other than ``TP_MODES`` (a strategy registered later) and a model
    family outside ``TP_FAMILIES`` (every family of the registry is in
    it).  A mesh without a 'model' axis passes."""
    names = tuple(mesh.mesh_dim_names)
    if "model" not in names:
        return
    what = None
    if mode not in TP_MODES:
        what = f"mode {mode!r}"
    elif cfg.family not in TP_FAMILIES:
        what = f"the {cfg.family} family ({cfg.name})"
    if what is not None:
        raise NotImplementedError(
            f"{what} on the mesh {names}: tensor parallelism trains the "
            f"{', '.join(TP_FAMILIES)} families under {', '.join(TP_MODES)}")


#: what :func:`pod_auto_moe_groups` returns for one group across ranks
POD_SPAN = 0


def pod_auto_moe_groups(batch_rows: int, pods: int, data: int,
                        model: int | None = None) -> int:
    """The MoE token groups among one rank's rows under the ``pod_auto``
    plan (``lags_hier``) on ``pods`` × ``data`` ranks, or ``POD_SPAN``.

    The reference takes each pod's gradient on its B/pods rows inside a
    vmap, where ``moe_forward_auto`` counts the auto 'pod' and 'data'
    axes as pods·data token groups, each dispatched with its own
    capacity.  A rank holds B/(pods·data) contiguous rows of its pod's
    slice, so when the groups divide the slice its rows are exactly
    ``pods`` of them.  Otherwise the reference dispatches the whole
    slice as one group: this rank's rows when ``data`` is 1; else a
    group that spans the pod's ranks (``POD_SPAN``: the step passes a
    ``models.moe.TokenSpan`` over the pod's 'data' group, which gathers
    its tokens).  That span on a mesh with a 'model' axis (of ``model``
    ranks; None: none) raises."""
    slice_rows = batch_rows // pods
    if slice_rows % (pods * data) == 0:
        return pods
    if data == 1:
        return 1
    if model is not None:
        raise NotImplementedError(
            f"lags_hier on {pods} pods x {data}: the reference dispatches "
            f"each pod's {slice_rows} rows as one MoE token group across "
            f"its ranks, not run beside a 'model' axis of {model} ranks "
            f"({TP_NEXT_FAMILIES})")
    return POD_SPAN


@dataclasses.dataclass(frozen=True)
class _OneWorker:
    """``exch`` over no worker axes (lags_hier on a single-pod mesh): its
    simulation path with P = 1 on this rank's leaves, as the reference
    runs the exchange with ``axis_names=None`` on a leading axis of 1."""
    exch: object

    @property
    def wave_granularity(self) -> str:
        return self.exch.wave_granularity

    def launch_bucket(self, wave, updates, state, axis_names, *, key=None):
        means, resids = self.exch.exchange_bucket(
            wave, [u[None] for u in updates], [e[None] for e in state], None,
            key=key)
        return lags._done(means, [e[0] for e in resids])

    def exchange_bucket(self, wave, updates, state, axis_names, *, key=None):
        return self.launch_bucket(wave, updates, state, axis_names).finish()


def _gather_dim(x, dim: int, axes: lags.Axes):
    """Every rank's chunk ``x`` of ``axes`` concatenated along ``dim``,
    in rank order (``x`` itself on one rank)."""
    if axes.size == 1:
        return x
    y = x.movedim(dim, 0).contiguous()
    out = torch.empty((axes.size * y.shape[0],) + tuple(y.shape[1:]),
                      dtype=y.dtype, device=y.device)
    dist.all_gather_into_tensor(out, y, group=axes.group)
    return out.movedim(0, dim).contiguous()


def _chunk_dim(x, dim: int, axes: lags.Axes):
    """This rank's chunk of ``x`` along ``dim`` over ``axes`` (a view)."""
    n = x.shape[dim] // axes.size
    return x.narrow(dim, dist.get_rank(axes.group) * n, n)


@dataclasses.dataclass(frozen=True)
class _WholeLeaves:
    """``exch`` on whole leaves, for the modes that select on them on a
    mesh with a 'model' axis (``slgs``, ``lags_hier2``, ``lags_hier``).

    ``layout[i]``: the (dim, :class:`~repro_torch.core.lags.Axes`) pairs
    leaf ``i``'s chunks are split over.  Each update and residual chunk
    is gathered to its full leaf, ``exch`` runs on the full leaves over
    the worker axes, and this rank's chunks of the mean and of every new
    residual are kept.  A leaf at a time, so that one full leaf's
    transients are alive at once; ``slgs`` (one wave of the whole model)
    all at once.  Nothing stays in flight: the launch finishes the
    exchange, and every rank of a leaf's chunk axes selects the same
    entries (redundantly)."""
    exch: object
    layout: tuple

    @property
    def wave_granularity(self) -> str:
        return self.exch.wave_granularity

    def _full(self, i: int, x):
        for dim, axes in self.layout[i]:
            x = _gather_dim(x, dim, axes)
        return x

    def _chunk(self, i: int, x):
        for dim, axes in self.layout[i]:
            x = _chunk_dim(x, dim, axes)
        return x.contiguous()

    def _run(self, ids, updates, state, axis_names, key):
        def each(fn, xs):
            return [fn(i, x) for i, x in zip(ids, xs)]
        tiers = isinstance(state, dict)
        full = ({t: each(self._full, v) for t, v in state.items()} if tiers
                else each(self._full, state))
        means, new = self.exch.exchange_bucket(
            ids, each(self._full, updates), full, axis_names, key=key)
        del full
        return (each(self._chunk, means),
                {t: each(self._chunk, v) for t, v in new.items()} if tiers
                else each(self._chunk, new))

    def launch_bucket(self, wave, updates, state, axis_names, *, key=None):
        ids = lags._wave_ids(wave)
        if self.wave_granularity == "model":
            return lags._done(*self._run(ids, updates, state, axis_names,
                                         key))
        tiers = isinstance(state, dict)
        means, new = [], ({t: [] for t in state} if tiers else [])
        for j, i in enumerate(ids):
            one = ({t: [v[j]] for t, v in state.items()} if tiers
                   else [state[j]])
            m, n = self._run((i,), [updates[j]], one, axis_names, key)
            means += m
            if tiers:
                for t in new:
                    new[t] += n[t]
            else:
                new += n
        return lags._done(means, new)

    def exchange_bucket(self, wave, updates, state, axis_names, *, key=None):
        return self.launch_bucket(wave, updates, state, axis_names,
                                  key=key).finish()


class DataShards:
    """``lags_hier``'s FSDP over 'data': each parameter a ``DTensor`` on
    the pod's ('data', 'model') sub-mesh, or its 'data' sub-mesh on a
    mesh without a 'model' axis; ``dims[i]`` the dim leaf ``i`` splits
    over 'data' (None: replicated over it), ``placements[i]`` its
    placements on the 'model' sub-mesh ``model_mesh`` (None: no 'model'
    axis), ``data`` the pod's 'data' ranks of this rank's model index.

    :meth:`leaves` gathers each leaf over 'data' OUTSIDE autograd into a
    fresh leaf that requires grad (on the 'model' sub-mesh, or a plain
    tensor): the forward and backward of the data-parallel layout then
    run on it, and
    :meth:`targets` are what the gradients are taken of.  :meth:`mean`
    reduce-scatters an update of that leaf over 'data' onto its FSDP dim
    and divides by the data size: this rank's block of the pod's dense
    mean.  (DTensor takes a ``Replicate`` placement to mean the same
    numbers on every rank, so the backward of a gather over 'data' inside
    autograd would keep each rank's own rows' share of the gradient and
    sum nothing.)"""

    def __init__(self, dims, placements, data: lags.Axes, model_mesh):
        self.dims, self.placements = list(dims), list(placements)
        self.data, self.model_mesh = data, model_mesh

    def leaves(self, params) -> list:
        from torch.distributed.tensor import DTensor
        out = []
        with torch.no_grad():
            for p, dim, pl in zip(params, self.dims, self.placements):
                x = D.local(p).detach()
                if dim is not None:
                    x = _gather_dim(x, dim, self.data)
                if self.model_mesh is not None:
                    x = DTensor.from_local(x, self.model_mesh, pl,
                                           run_check=False)
                out.append(x.requires_grad_())
        return out

    def targets(self, params, leaves) -> list:
        return leaves

    def mean(self, i: int, u):
        dim = self.dims[i]
        if dim is None:
            dist.all_reduce(u, op=dist.ReduceOp.SUM, group=self.data.group)
        elif self.data.size > 1:
            y = u.movedim(dim, 0).contiguous()
            out = torch.empty((y.shape[0] // self.data.size,)
                              + tuple(y.shape[1:]), dtype=y.dtype,
                              device=y.device)
            dist.reduce_scatter_tensor(out, y, op=dist.ReduceOp.SUM,
                                       group=self.data.group)
            u = out.movedim(0, dim).contiguous()
        return u.div_(self.data.size)


def param_axes(mesh, mode: str) -> tuple | None:
    """The axes of the sub-mesh the parameters are ``DTensor``s on:
    'model' when the mesh has it, 'data' first under ``lags_hier`` (FSDP,
    on every mesh); None (plain replicas) for the other modes on a mesh
    without 'model'."""
    axes = (("data",) if mode == "lags_hier" else ()) + (
        (D.MODEL,) if D.MODEL in mesh.mesh_dim_names else ())
    return axes or None


def make_state_specs(cfg, mesh, *, method: str | None = None,
                     pipeline: str = "off",
                     momentum_correction: float = 0.0):
    """(state specs, meta) of this rank's train state: ``Spec`` leaves
    (shape, dtype, device), no allocation.  ``pipeline="async1"`` adds
    ``"pending"`` (the previous step's updates, this rank's worker
    slice)."""
    if pipeline not in WW.PIPELINE_MODES:
        raise ValueError(f"pipeline={pipeline!r} not in "
                         f"{WW.PIPELINE_MODES}")
    mode, manual, worker = _mode(cfg, mesh, method)
    check_tensor_parallel(cfg, mesh, mode)
    dev = M.device_of(mesh)
    params = tree.map(lambda m: Spec(m.shape, m.dtype, dev),
                      T.abstract_params(cfg))
    # on a 'model' axis, or over 'data' under lags_hier, each rank holds
    # one chunk of a parameter (its Spec keeps the full shape, a
    # DTensor's), and of its worker states: under lags_hier a block, FSDP
    # over 'data' (beside 'model')
    pspecs = None
    axes = param_axes(mesh, mode)
    chunks = params
    if axes is not None:
        pspecs = param_pspecs(cfg, mesh, mode, params)
        sizes = {a: s for a, s in rules.mesh_axis_sizes(mesh).items()
                 if a in axes}
        leaves, treedef = tree.flatten(params)
        chunks = tree.unflatten(treedef, [
            Spec(D.local_shape(s.shape, spec, sizes), s.dtype, dev)
            for s, spec in zip(leaves, tree.flatten_up_to(treedef, pspecs))])

    def local(s):
        # this rank's worker slice of a per-worker f32 state
        return Spec((1,) + s.shape, torch.float32, dev)

    ef = () if mode == "dense" else tree.map(local, chunks)
    tiers = R.get_exchange(mode).ef_tiers
    if ef and tiers:
        # two-tier exchanges: one residual tree per tier, same layout
        ef = {t: ef for t in tiers}
    state = {"params": params, "ef": ef,
             "step": Spec((), torch.int64, torch.device("cpu"))}
    if pipeline == "async1":
        state["pending"] = tree.map(local, chunks)
    if momentum_correction > 0.0:
        state["extra"] = {"mom": tree.map(local, chunks)}
    meta = {"mode": mode, "manual": manual, "worker_axes": worker,
            "n_workers": M.n_workers(mesh, worker), "pipeline": pipeline,
            "pspecs": pspecs, "param_axes": axes}
    return state, meta


def build_train_step(cfg, mesh, run: RunConfig):
    """(step_fn, state_specs, meta) from one ``RunConfig``.

    ``step_fn(state, batch) -> (state, metrics)``: ``batch`` is the
    global batch ({"tokens", "labels"} (B, S) on this rank's device, the
    same on every rank); ``metrics = {"loss"}``, the mean over ranks.
    ``meta`` carries ``mode``, ``n_workers``, ``manual``,
    ``worker_axes``, ``ks``, ``schedule``, ``run``, ``waves`` (the
    ``WaveSchedule`` of a pipelined run, else None), ``exchange`` and
    ``axes`` (the exchange the step runs and the ``lags.Axes`` it runs
    over, None for none).
    With ``run.health_every > 0`` the metrics carry the health
    quantities (module docstring).
    ``step_fn(state, batch, marks=[])`` under ``pipeline="wave"`` fills
    the list with each wave's launch marks (``pipeline.step.launch_leads``
    reads them); without it nothing is recorded."""
    state_specs, meta = make_state_specs(
        cfg, mesh, method=run.mode, pipeline=run.pipeline,
        momentum_correction=run.momentum_correction)
    mode, worker = meta["mode"], meta["worker_axes"]
    strat = R.get_exchange(mode)
    ks_override = R.resolve_schedule_ks(run.schedule, mode,
                                        state_specs["params"],
                                        n_workers=meta["n_workers"])
    # the parameters are DTensors over 'model' and/or (lags_hier) 'data';
    # dense and lags_dp exchange each rank's chunk of the block rows, the
    # other modes whole leaves
    tp = meta["pspecs"] is not None
    whole = tp and mode not in TP_CHUNK_MODES
    rows = (M.worker_axes(mesh, (D.MODEL,))
            if D.MODEL in mesh.mesh_dim_names else None)
    exch = R.build_exchange(R.ExchangeSpec(
        mode=mode, params_like=state_specs["params"],
        ratio=run.resolved_ratio(cfg), ks=ks_override,
        block_size=run.block_size,
        compressor=run.compressor, selection_backend=run.selection_backend,
        inner_compressor=run.inner_compressor, sim=False,
        n_workers=meta["n_workers"], ratio_inner=run.resolved_ratio_inner(),
        n_inner=max(1, M.n_workers(mesh, M.inner_axis_names(mesh))),
        shard_dims=(rules.shard_dims_tree(state_specs["params"],
                                          meta["pspecs"], meta["param_axes"])
                    if tp else None),
        row_axes=None if whole else rows,
        momentum_correction=run.momentum_correction))
    # every rank of the data axes (of this rank's model index): the batch
    # split and the loss mean
    ranks = M.worker_axes(mesh, M.data_axis_names(mesh))
    rank, n_ranks = dist.get_rank(ranks.group), ranks.size
    axes = M.worker_axes(mesh, worker)
    # pod_auto: the pod's update is the dense mean of its ranks'
    inner = (M.worker_axes(mesh, M.inner_axis_names(mesh))
             if strat.axes == "pod_auto" else None)
    step_exch = exch if axes is not None else _OneWorker(exch)
    shards = dims = None
    if tp:
        specs = tree.flatten_up_to(tree.flatten(state_specs["params"])[1],
                                   meta["pspecs"])
        # per leaf, the dim each of its sub-mesh's axes splits (or None)
        dims = [{a: rules.sharded_dim(spec, a) for a in meta["param_axes"]}
                for spec in specs]
    if whole:
        over = {"data": inner, "model": rows}
        step_exch = _WholeLeaves(step_exch, tuple(
            tuple((d[a], over[a]) for a in meta["param_axes"]
                  if d[a] is not None) for d in dims))
        if strat.axes == "pod_auto":
            shards = DataShards(
                [d["data"] for d in dims],
                [None if rows is None else rules.placements(spec, D.MODEL)
                 for spec in specs], inner,
                None if rows is None else D.sub_mesh(mesh))
    meta["ks"] = getattr(exch, "ks", None)
    meta["schedule"] = run.schedule
    meta["run"] = dataclasses.replace(run, mode=mode)
    meta["exchange"], meta["axes"] = exch, axes
    dev = M.device_of(mesh)
    mc = float(run.momentum_correction)
    pipeline = run.pipeline
    ef_tiers = strat.ef_tiers

    # wave partition of the pipelined modes: a given schedule is re-bound
    # by leaf name against THIS params tree; otherwise the geometry
    # default at the exchange's granularity (slgs: one wave)
    waves = None
    if pipeline != "off":
        if run.waves is not None:
            waves = WB.bind(run.waves, state_specs["params"])
        else:
            waves = WW.default_waves(
                state_specs["params"], meta["ks"],
                granularity=exch.wave_granularity,
                target_bytes=run.wave_target_bytes, pipeline=pipeline)
    meta["waves"] = waves

    # online convergence health (repro_torch.observe.health): zero work
    # when health_every == 0; needs per-leaf budgets, so slgs (whole-model
    # k_total) and dense are skipped.  Its sums run over the exchange's
    # worker axes; lags_hier2's delta over the pods (its outer residual
    # is the same on every rank of a pod)
    health = (run.health_every > 0 and mode != "dense"
              and meta["ks"] is not None)
    h_ks = tree.leaves(meta["ks"]) if health else ()
    # Eq. 20's d: the full leaf's, whatever a rank holds of it
    h_ds = [math.prod(s.shape) for s in tree.leaves(state_specs["params"])]
    h_axes = axes
    if ef_tiers:
        h_axes = (axes.sub((exch.outer_axis,))
                  if health and axes is not None else None)
    h_tier = ("flat" if strat.axes == "data_manual" and not ef_tiers
              else "outer")

    def wsum(x):
        """``x`` summed over the workers (in place)."""
        if axes is not None:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axes.group)
        return x

    # DTensor parameters: each rank's sums of squares cover its chunk of
    # each leaf; the leaf's are their sum over the axes of its sub-mesh,
    # a chunk held alike by several ranks (replicated over an axis)
    # counted by the first of them only
    chunk_sum = None
    if health and tp:
        owner = torch.tensor(
            [float(all(d[a] is not None or mesh.get_local_rank(a) == 0
                       for a in meta["param_axes"])) for d in dims],
            device=dev)
        groups = [mesh.get_group(a) for a in meta["param_axes"]
                  if mesh.size(mesh.mesh_dim_names.index(a)) > 1]

        def chunk_sum(x):
            """(..., L) per-leaf sums of this rank's chunks -> the whole
            leaves' (one all-reduce of the stack over each axis)."""
            x = x * owner
            for g in groups:
                dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
            return x

    def leaf_sums(*xs):
        """Each per-leaf (L,) vector summed over the workers, then over
        the chunks of each leaf."""
        xs = [wsum(x) for x in xs]
        return xs if chunk_sum is None else list(chunk_sum(torch.stack(xs)))

    def health_metrics(flat_mean, new_ef, acc_sq, stale) -> dict:
        """The health metrics of one step: ``acc_sq`` the per-leaf
        ``||e + u||^2`` of this rank (None when the wave hooks consumed
        the updates), ``stale`` this rank's (||u_t||^2, ||u_t -
        u_{t-1}||^2) per leaf under async1, else None."""
        resid = new_ef["outer"] if ef_tiers else new_ef
        n = h_axes.size if h_axes is not None else 1
        nums, dens = [], []
        for i, (e, m) in enumerate(zip(resid, flat_mean)):
            e_sum = e
            if h_axes is not None:
                e_sum = e.clone(memory_format=torch.contiguous_format)
                with lags._comm_scope(h_tier, "allreduce", f"health/l{i}",
                                      4.0 * e_sum.numel(), n):
                    dist.all_reduce(e_sum, op=dist.ReduceOp.SUM,
                                    group=h_axes.group)
            num, den = H.delta_sums(e_sum, m, n)
            nums.append(num)
            dens.append(den)
            del e_sum
        num, den = torch.stack(nums), torch.stack(dens)
        if chunk_sum is not None:
            num, den = chunk_sum(torch.stack([num, den]))
        deltas, energies = zip(*(
            H.delta_from_sums(num[i], den[i], int(h_ks[i]), h_ds[i])
            for i in range(len(nums))))
        delta = torch.stack(deltas)
        out = {"health_delta": delta, "health_delta_max": delta.max()}
        if ef_tiers:
            out["health_ef_energy_outer"] = torch.stack(energies)
            if acc_sq is not None:
                out["health_ef_energy_inner"] = H.safe_ratio(*leaf_sums(
                    H.sq_leaves(new_ef["inner"]), acc_sq))
        elif acc_sq is None:
            # the wave taps consumed the updates: the aggregate form
            out["health_ef_energy_flat"] = torch.stack(energies)
        else:
            out["health_ef_energy_flat"] = H.safe_ratio(*leaf_sums(
                H.sq_leaves(resid), acc_sq))
        if stale is not None:
            if chunk_sum is not None:
                stale = chunk_sum(torch.stack([torch.stack(stale[0]),
                                               torch.stack(stale[1])]))
            out["health_staleness"] = H.staleness_gap(
                wsum(torch.stack([sum(stale[0])])),
                wsum(torch.stack([sum(stale[1])])))[0]
        return out

    def loss_fn(params, batch, moe_groups):
        return T.loss_fn(params, cfg, batch, chunk=run.chunk,
                         loss_chunk=run.loss_chunk, moe_groups=moe_groups)

    def moe_groups(batch_rows: int):
        if strat.axes != "pod_auto" or not cfg.n_experts:
            return 1
        groups = pod_auto_moe_groups(batch_rows, meta["n_workers"],
                                     inner.size,
                                     model=None if rows is None else rows.size)
        if groups != POD_SPAN:
            return groups
        return MO.TokenSpan(inner.group, inner.size,
                            dist.get_rank(inner.group))

    def replicated():
        """Plain tensors meet the DTensor parameters as replicas
        (the rope tables, masks and accumulators of the model), through
        the forward and the backward."""
        if not tp:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        return implicit_replication()

    def shard(x):
        b = x.shape[0]
        if b % n_ranks:
            raise ValueError(f"global batch {b} does not split over "
                             f"{n_ranks} ranks")
        per = b // n_ranks
        return x[rank * per:(rank + 1) * per]

    def local(ef):
        """This rank's worker slice of the EF state: flat leaves without
        the leading 1 (one list per tier for two-tier exchanges)."""
        if mode == "dense":
            return ()
        flat = WS.flatten_state(ef, ef_tiers)
        if isinstance(flat, dict):
            return {t: [e[0] for e in v] for t, v in flat.items()}
        return [e[0] for e in flat]

    def stacked(flat, treedef):
        if mode == "dense":
            return ()
        if isinstance(flat, dict):
            return {t: tree.unflatten(treedef, [e[None] for e in v])
                    for t, v in flat.items()}
        return tree.unflatten(treedef, [e[None] for e in flat])

    def update_of(i, g, lr, mom, stale=None):
        """``u = lr·f32(g)`` of leaf ``i``, the pod's mean of it under
        pod_auto (this rank's block of it under ``shards``), and the
        velocity ``mom = mc·mom + u`` (in place) under mc.  ``u`` is
        contiguous, as NCCL's buffers must be (a gradient may be
        strided: the sLSTM's on the card).  ``stale`` (async1 health
        under mc, where the pending update IS the old velocity): gets
        ``||mom_new - mom_old||^2`` appended before the old one is
        overwritten."""
        u = g.float().contiguous().mul_(lr)
        if shards is not None:
            u = shards.mean(i, u)
        elif inner is not None:
            dist.all_reduce(u, op=dist.ReduceOp.SUM, group=inner.group)
            u.div_(inner.size)
        if mom is None:
            return u
        if stale is None:
            return mom[0].mul_(mc).add_(u)
        new = mom[0] * mc + u      # the same two roundings as in place
        stale.append(H.sq_norm(new - mom[0]))
        return mom[0].copy_(new)

    def step(state, batch, *, marks: list | None = None):
        params = state["params"]
        leaves, treedef = tree.flatten(params)
        local_batch = tree.map(shard, batch)
        groups = moe_groups(batch["tokens"].shape[0])
        lr = torch.as_tensor(run.lr_at(state["step"]), dtype=torch.float32,
                             device=dev)
        ef_local = local(state["ef"])
        key = run.key_at(state["step"])
        out = {k: v for k, v in state.items() if k not in ("ef", "step")}
        acc_sq = stale = None
        if pipeline == "wave" and inner is None:
            # each wave's exchange launches inside backprop (hooks)
            with replicated():
                (loss, _aux), mean_upd, new_ef_local = WS.wave_backward(
                    lambda p: loss_fn(p, local_batch, groups), step_exch,
                    waves.waves, params,
                    WS.unflatten_state(ef_local, treedef), axes, lr=lr,
                    key=key, has_aux=True, tiers=ef_tiers, marks=marks,
                    grad_of=D.grad_to_local if tp else None)
            flat_mean = tree.leaves(mean_upd)
            new_ef = WS.flatten_state(new_ef_local, ef_tiers)
            del mean_upd, new_ef_local
        else:
            launched = None
            if pipeline == "async1":
                # the previous step's exchange runs against this step's
                # forward and backward, with that step's stream
                pend = [x[0] for x in tree.leaves(state["pending"])]
                with torch.no_grad():
                    launched = WS.launch_waves(
                        step_exch, waves.waves, pend, ef_local, axes,
                        key=run.key_at(state["step"] - 1))
                    if health:     # before mc overwrites the pending
                        acc_sq = H.acc_sq_leaves(
                            ef_local["inner"] if ef_tiers else ef_local, pend)
                        stale = ([], [])
                if stale is None or mc > 0.0:
                    del pend
            with replicated():
                # lags_hier's FSDP: the forward on leaves gathered over
                # 'data' outside autograd
                fwd = leaves if shards is None else shards.leaves(leaves)
                loss, _aux = loss_fn(tree.unflatten(treedef, fwd),
                                     local_batch, groups)
                wrt = fwd if shards is None else shards.targets(leaves, fwd)
                del fwd
                grads = list(torch.autograd.grad(loss, wrt))
                for i, p in enumerate(wrt):
                    # in place: each gradient goes as its chunk lands
                    grads[i] = D.grad_to_local(grads[i], p)
                del wrt
            moms = (tree.leaves(state["extra"]["mom"]) if mc > 0.0
                    else [None] * len(grads))
            with torch.no_grad():
                # DGC momentum correction: the velocity accumulates
                # BEFORE sparsification, per worker (in place)
                diffs = stale[1] if stale is not None and mc > 0.0 else None
                updates = [update_of(i, g, lr, m, diffs)
                           for i, (g, m) in enumerate(zip(grads, moms))]
                del grads
                if stale is not None:
                    stale[0].extend(H.sq_norm(u) for u in updates)
                    if mc == 0.0:
                        stale[1].extend(H.sq_norm(u - q)
                                        for u, q in zip(updates, pend))
                        del pend
                elif health:
                    acc_sq = H.acc_sq_leaves(
                        ef_local["inner"] if ef_tiers else ef_local, updates)
                if pipeline == "async1":
                    flat_mean, new_ef = WS.finish_waves(launched, waves.waves,
                                                        ef_local)
                    del launched
                    out["pending"] = (state["extra"]["mom"] if mc > 0.0
                                      else tree.unflatten(
                                          treedef, [u[None] for u in updates]))
                elif pipeline == "wave":
                    # lags_hier: the waves after backward (its update is
                    # the pod's mean), as the reference's pure-auto path
                    flat_mean, new_ef = WS.finish_waves(
                        WS.launch_waves(step_exch, waves.waves, updates,
                                        ef_local, axes, key=key),
                        waves.waves, ef_local)
                else:
                    flat_mean, new_ef = step_exch.exchange_bucket(
                        tuple(range(len(leaves))), updates, ef_local, axes,
                        key=key)
                del updates
        del ef_local
        metrics = {}
        with torch.no_grad():
            if health:
                metrics = health_metrics(flat_mean, new_ef, acc_sq, stale)
            for p, d in zip(leaves, flat_mean):
                p = D.local(p)      # a DTensor's chunk, in place
                p.copy_(p.float() - d)
            del flat_mean
            loss = (loss.detach().full_tensor() if D.is_dtensor(loss)
                    else loss.detach().clone())
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=ranks.group)
            loss = loss / n_ranks
        out["ef"] = stacked(new_ef, treedef)
        out["step"] = state["step"] + 1
        return out, {"loss": loss} | metrics

    return step, state_specs, meta


def init_state(cfg, mesh, *, method: str | None = None, seed: int = 0,
               pipeline: str = "off", momentum_correction: float = 0.0,
               params=None):
    """This rank's train state, materialised on the mesh's device.

    ``params``: a parameter tree that requires grad, e.g.
    ``Transformer.params`` or ``from_jax_params(...).params`` (so the port
    and the reference start from the same numbers; the reference draws
    its own from ``PRNGKey(seed)``, which torch cannot reproduce).  By
    default a ``Transformer`` is drawn from ``seed``, the same on every
    rank.  On a mesh with a 'model' axis the full tree (the same on
    every rank) is laid out as ``DTensor``s by the step's specs
    (``sharding.dtensor.distribute``: each rank keeps its chunk, and the
    caller may drop the full tree); a tree of DTensors passes as it is."""
    state_specs, meta = make_state_specs(
        cfg, mesh, method=method, pipeline=pipeline,
        momentum_correction=momentum_correction)
    dev = M.device_of(mesh)
    if params is None:
        params = T.Transformer(cfg, seed=seed, device=dev).params
    for path, p, s in zip(tree.leaf_paths(params), tree.leaves(params),
                          tree.leaves(state_specs["params"])):
        if tuple(p.shape) != s.shape or p.dtype != s.dtype \
                or p.device != dev:
            raise ValueError(f"parameter {path}: {p.dtype}{tuple(p.shape)} "
                             f"on {p.device}, the step takes "
                             f"{s.dtype}{s.shape} on {dev}")

    if meta["pspecs"] is not None and not all(
            D.is_dtensor(p) for p in tree.leaves(params)):
        params = D.distribute(params, meta["pspecs"], mesh,
                              meta["param_axes"])

    def zeros(s):
        return torch.zeros(s.shape, dtype=s.dtype, device=s.device)

    state = {"params": params, "ef": tree.map(zeros, state_specs["ef"]),
             "step": 0}
    if "pending" in state_specs:
        # the async1 double buffer starts empty: step 0 exchanges zeros
        # and applies a zero update while its own updates fill it
        state["pending"] = tree.map(zeros, state_specs["pending"])
    # this rank holds one worker's slice of the per-worker extra state
    extra = R.ExchangeSpec(mode=meta["mode"], params_like=params,
                           n_workers=1,
                           momentum_correction=momentum_correction
                           ).init_extra_state(tree.map(D.local, params))
    if extra:
        state["extra"] = extra
    return state, meta
