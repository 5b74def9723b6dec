"""Distributed data-parallel train step: the counterpart of
``repro.launch.train`` for ``pipeline="off"``.

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
     feedback, the sparse (values, indices) all-gathered leaf by leaf);
  4. ``p <- (f32(p) − mean).to(p.dtype)``: plain SGD on pre-scaled
     deltas (Algorithm 1 line 10), not ``optim.SGD``.

The loss is all-reduce-averaged.  State: ``{"params", "ef", "step"}``,
plus ``"extra": {"mom"}`` when mc > 0.  ``ef`` and ``mom`` hold this
rank's worker slice, leaves (1, ...) f32 (the reference's per-worker
state under its manual axes); ``step`` is a Python int.  The port
updates the parameters and the velocity in place, which saves one copy
of each.

Not ported yet: ``pipeline != "off"`` (ROADMAP.md queue 1 item 11),
``health_every > 0`` (item 12), ``schedule`` (item 10), ``slgs`` (item 8)
and the hierarchy (item 9).
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
    (shape, dtype, device), no allocation."""
    if pipeline != "off":
        raise NotImplementedError(
            f"pipeline={pipeline!r} is not ported yet (ROADMAP.md queue 1 "
            f"item 11)")
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
    ``meta`` carries ``mode``, ``n_workers``, ``manual``, ``ks`` and
    ``run``."""
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

    def step(state, batch):
        params = state["params"]
        leaves, treedef = tree.flatten(params)
        loss, _aux = loss_fn(params, tree.map(shard, batch))
        grads = list(torch.autograd.grad(loss, leaves))
        lr = torch.as_tensor(run.lr_at(state["step"]), dtype=torch.float32,
                             device=dev)
        with torch.no_grad():
            if mc > 0.0:
                # DGC momentum correction: the velocity accumulates
                # BEFORE sparsification, per worker (in place)
                updates = [m[0].mul_(mc).add_(g.float().mul_(lr))
                           for m, g in zip(
                               tree.leaves(state["extra"]["mom"]), grads)]
            else:
                updates = [g.float().mul_(lr) for g in grads]
            del grads
            if mode == "dense":
                mean_upd, _ = exch.exchange(
                    tree.unflatten(treedef, updates), (), axes)
                new_ef = ()
            else:
                ef_local = tree.map(lambda e: e[0], state["ef"])
                mean_upd, new_ef_local = exch.exchange(
                    tree.unflatten(treedef, updates), ef_local, axes)
                del ef_local
                new_ef = tree.map(lambda e: e[None], new_ef_local)
                del new_ef_local
            del updates
            for p, d in zip(leaves, tree.leaves(mean_upd)):
                p.copy_(p.float() - d)
            del mean_upd
            loss = loss.detach().clone()
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=axes.group)
            loss = loss / axes.size
        out = {"params": params, "ef": new_ef, "step": state["step"] + 1}
        if "extra" in state:
            out["extra"] = state["extra"]
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
    # this rank holds one worker's slice of the per-worker extra state
    extra = R.ExchangeSpec(mode=meta["mode"], params_like=params,
                           n_workers=1,
                           momentum_correction=momentum_correction
                           ).init_extra_state()
    if extra:
        state["extra"] = extra
    return state, meta
