"""Distributed data-parallel train step: the counterpart of
``repro.launch.train``.

Build steps through ``repro_torch.api`` (``Session(cfg, run,
mesh=...).train_step()`` or ``build_train_step(cfg, mesh, run)``).  One
process per worker; each runs the step on its own rank, as the
reference's shard_map ``worker`` runs on its manual-axis shard:

  1. the gradient of the loss on this rank's rows of the global batch
     (rank r takes rows [r·B/P, (r+1)·B/P), the simulation surface's
     split);
  2. ``u = lr·g`` in f32, or the DGC velocity ``mom = mc·mom + lr·g``
     when ``momentum_correction`` mc > 0;
  3. the exchange over the data axis: ``dense`` all-reduces the mean,
     ``lags_dp`` runs ``BlockLAGSExchange`` (per-block top-k with error
     feedback, the sparse (values, indices) all-gathered leaf by leaf),
     ``slgs`` one global top-k over the whole-model vector;
  4. ``p <- (f32(p) − mean).to(p.dtype)``: plain SGD on pre-scaled
     deltas (Algorithm 1 line 10), not ``optim.SGD``.

``run.pipeline`` says when step 3 runs (``repro_torch.pipeline``):
``"off"`` after backward; ``"wave"`` inside backprop, each wave of leaves
launched by autograd hooks as its gradients land and finished after
backward (bitwise equal to ``"off"``); ``"async1"`` exchanges the
PREVIOUS step's updates (``state["pending"]``, zeros at step 0): launched
before the forward, finished after the backward, while this step's
updates (the velocity under mc) become the new pending — one step of
bounded staleness.

The loss is all-reduce-averaged.  State: ``{"params", "ef", "step"}``,
plus ``"extra": {"mom"}`` when mc > 0 and ``"pending"`` under
``async1``.  ``ef``, ``mom`` and ``pending`` hold this rank's worker
slice, leaves (1, ...) f32 (the reference's per-worker state under its
manual axes); ``step`` is a Python int.  The port updates the
parameters and the velocity in place, which saves one copy of each;
under ``async1`` with mc the pending leaves are the velocity's own.

Not ported yet: ``health_every > 0`` (ROADMAP.md queue 1 item 12),
``schedule`` (item 10) and the hierarchy (item 9).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.api import registry as R
from repro_torch.api.config import RunConfig, canonical_mode
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.pipeline import buckets as WB
from repro_torch.pipeline import step as WS
from repro_torch.pipeline import waves as WW
from repro_torch.training.train_loop import Spec


def _mode(cfg, mesh, method: str | None):
    """(mode, manual axes): every ported strategy runs manual over the
    data axes."""
    mode = canonical_mode(method or cfg.train_mode)
    R.get_exchange(mode)            # unknown modes raise here
    return mode, M.data_axis_names(mesh)


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
    mode, manual = _mode(cfg, mesh, method)
    dev = M.device_of(mesh)
    params = tree.map(lambda m: Spec(m.shape, m.dtype, dev),
                      T.abstract_params(cfg))

    def local(s):
        # this rank's worker slice of a per-worker f32 state
        return Spec((1,) + s.shape, torch.float32, dev)

    state = {"params": params,
             "ef": () if mode == "dense" else tree.map(local, params),
             "step": Spec((), torch.int64, torch.device("cpu"))}
    if pipeline == "async1":
        state["pending"] = tree.map(local, params)
    if momentum_correction > 0.0:
        state["extra"] = {"mom": tree.map(local, params)}
    meta = {"mode": mode, "manual": manual,
            "n_workers": M.n_workers(mesh, manual), "pipeline": pipeline}
    return state, meta


def build_train_step(cfg, mesh, run: RunConfig):
    """(step_fn, state_specs, meta) from one ``RunConfig``.

    ``step_fn(state, batch) -> (state, metrics)``: ``batch`` is the
    global batch ({"tokens", "labels"} (B, S) on this rank's device, the
    same on every rank); ``metrics = {"loss"}``, the mean over workers.
    ``meta`` carries ``mode``, ``n_workers``, ``manual``, ``ks``, ``run``
    and ``waves`` (the ``WaveSchedule`` of a pipelined run, else None).
    ``step_fn(state, batch, marks=[])`` under ``pipeline="wave"`` fills
    the list with each wave's launch marks (``pipeline.step.launch_leads``
    reads them); without it nothing is recorded."""
    unported = run.unported()
    if unported:
        raise NotImplementedError(f"not ported yet: {unported}")
    state_specs, meta = make_state_specs(
        cfg, mesh, method=run.mode, pipeline=run.pipeline,
        momentum_correction=run.momentum_correction)
    mode, manual = meta["mode"], meta["manual"]
    p_workers = meta["n_workers"]
    exch = R.build_exchange(R.ExchangeSpec(
        mode=mode, params_like=state_specs["params"],
        ratio=run.resolved_ratio(cfg), block_size=run.block_size,
        compressor=run.compressor, selection_backend=run.selection_backend,
        sim=False, n_workers=p_workers,
        momentum_correction=run.momentum_correction))
    meta["ks"] = getattr(exch, "ks", None)
    meta["run"] = dataclasses.replace(run, mode=mode)
    axes = M.worker_axes(mesh, manual)
    rank = dist.get_rank(axes.group)
    dev = M.device_of(mesh)
    mc = float(run.momentum_correction)
    pipeline = run.pipeline
    ef_tiers = R.get_exchange(mode).ef_tiers

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

    def loss_fn(params, batch):
        return T.loss_fn(params, cfg, batch, chunk=run.chunk,
                         loss_chunk=run.loss_chunk)

    def shard(x):
        b = x.shape[0]
        if b % p_workers:
            raise ValueError(f"global batch {b} does not split over "
                             f"{p_workers} workers")
        per = b // p_workers
        return x[rank * per:(rank + 1) * per]

    def step(state, batch, *, marks: list | None = None):
        params = state["params"]
        leaves, treedef = tree.flatten(params)
        local_batch = tree.map(shard, batch)
        lr = torch.as_tensor(run.lr_at(state["step"]), dtype=torch.float32,
                             device=dev)
        ef_local = ([e[0] for e in tree.leaves(state["ef"])]
                    if mode != "dense" else ())
        out = {k: v for k, v in state.items() if k not in ("ef", "step")}
        if pipeline == "wave":
            # each wave's exchange launches inside backprop (hooks)
            (loss, _aux), mean_upd, new_ef_local = WS.wave_backward(
                lambda p: loss_fn(p, local_batch), exch, waves.waves,
                params, WS.unflatten_state(ef_local, treedef), axes, lr=lr,
                has_aux=True, tiers=ef_tiers, marks=marks)
            flat_mean = tree.leaves(mean_upd)
            new_ef = WS.flatten_state(new_ef_local, ef_tiers)
            del mean_upd, new_ef_local
        else:
            launched = None
            if pipeline == "async1":
                # the previous step's exchange runs against this step's
                # forward and backward
                pend = [x[0] for x in tree.leaves(state["pending"])]
                with torch.no_grad():
                    launched = WS.launch_waves(exch, waves.waves, pend,
                                               ef_local, axes)
                del pend
            loss, _aux = loss_fn(params, local_batch)
            grads = list(torch.autograd.grad(loss, leaves))
            with torch.no_grad():
                if mc > 0.0:
                    # DGC momentum correction: the velocity accumulates
                    # BEFORE sparsification, per worker (in place)
                    updates = [m[0].mul_(mc).add_(g.float().mul_(lr))
                               for m, g in zip(
                                   tree.leaves(state["extra"]["mom"]),
                                   grads)]
                else:
                    updates = [g.float().mul_(lr) for g in grads]
                del grads
                if pipeline == "async1":
                    flat_mean, new_ef = WS.finish_waves(launched, waves.waves,
                                                        ef_local)
                    del launched
                    out["pending"] = (state["extra"]["mom"] if mc > 0.0
                                      else tree.unflatten(
                                          treedef, [u[None] for u in updates]))
                else:
                    flat_mean, new_ef = exch.exchange_bucket(
                        tuple(range(len(leaves))), updates, ef_local, axes)
                del updates
        del ef_local
        with torch.no_grad():
            for p, d in zip(leaves, flat_mean):
                p.copy_(p.float() - d)
            del flat_mean
            loss = loss.detach().clone()
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=axes.group)
            loss = loss / axes.size
        out["ef"] = (() if mode == "dense" else
                     tree.unflatten(treedef, [e[None] for e in new_ef]))
        out["step"] = state["step"] + 1
        return out, {"loss": loss}

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
    rank."""
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
                           ).init_extra_state()
    if extra:
        state["extra"] = extra
    return state, meta
