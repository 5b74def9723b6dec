"""``SimTrainer``: P simulated workers on one device, as
``repro.training.train_loop.SimTrainer`` runs them.

One step: each worker takes the gradient of ``loss_fn`` on its batch
(the workers run one after another, so only one worker's activations
are alive at a time); ``u = lr·g`` in f32 is stacked into (P, ...)
leaves — or, with ``momentum_correction`` mc > 0, the DGC velocity
``mom = mc·mom + lr·g`` is, per worker, before sparsification; the
exchange turns (u, residual) into the mean update and the new residual;
``SGD`` and ``apply_deltas`` apply the mean.  Parameters and the
velocity are updated in place.

Like the reference's ``SimTrainer``, it never reads ``run.pipeline``: the
simulation surface always runs the monolithic post-backward exchange
(``wave`` is bitwise equal to it; ``async1`` and the in-backprop waves
are the distributed step's, ``repro_torch.launch.train``).  Every
registered mode runs here: ``dense``, ``lags_dp``, ``slgs``,
``lags_hier`` (the per-leaf exchange over P workers, one per pod, as the
reference's) and ``lags_hier2`` (P factors as pods × ``inner_workers``;
the state's ``"ef"`` is ``{"inner", "outer"}``, from ``exchange.init``).

``run.schedule`` (an autotuned ``Schedule``/``HierSchedule``) replaces
the scalar ratio's budgets through ``registry.resolve_schedule_ks``,
the distributed step's ingestion path.  Each step passes
``run.key_at(step)`` to the exchange, so key-needing compressors draw
fresh indices every step.  ``run.measure_delta`` under ``lags_dp``
adds the Eq. 20 metric of every leaf on ``acc = e + u`` before the
exchange (``delta_max``, ``delta_mean``, ``delta_per_leaf`` in flatten
order), its RandK draws from ``Key(17)`` with the step and the leaf
folded in, as the reference's.

``run.health_every > 0`` adds the convergence-health quantities of
``repro_torch.observe.health`` to every step's metrics, from what the
exchange returned (modes with per-leaf budgets: not ``dense`` or
``slgs``): ``health_delta`` (the online Eq. 20 delta per leaf, in
flatten order, ``health_leaf_names``), ``health_delta_max`` and
``health_ef_energy_flat`` — for ``lags_hier2`` the delta of the outer
tier and ``health_ef_energy_inner``/``_outer`` — as the reference's.
``health_every == 0`` adds no key and no work.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device, tree
from repro_torch.api import registry as R
from repro_torch.api.config import RunConfig
from repro_torch.core import assumption
from repro_torch.core import compressors as C
from repro_torch.observe import health as H
from repro_torch.optim import optimizers as opt


class Spec:
    """Shape, dtype and device of a tensor not yet allocated (the
    counterpart of ``jax.ShapeDtypeStruct``)."""

    def __init__(self, shape, dtype, device):
        self.shape, self.dtype, self.device = tuple(shape), dtype, device


def _sim_spec(run: RunConfig, params, n_workers: int) -> R.ExchangeSpec:
    mode = run.resolved_mode()
    ks = R.resolve_schedule_ks(run.schedule, mode, params,
                               n_workers=n_workers)
    return R.ExchangeSpec(mode=mode, params_like=params,
                          ratio=run.resolved_ratio(), ks=ks,
                          compressor=run.compressor,
                          selection_backend=run.selection_backend,
                          inner_compressor=run.inner_compressor,
                          block_size=run.block_size, sim=True,
                          n_workers=n_workers,
                          ratio_inner=run.resolved_ratio_inner(),
                          n_inner=run.inner_workers or 1,
                          momentum_correction=run.momentum_correction)


class SimTrainer:
    """P simulated workers; batches arrive with a leading (P,) axis.

    ``loss_fn(params, batch) -> (loss, aux)``; ``params`` is a tree of
    tensors that require grad (``Transformer.params``), all on
    ``device``."""

    def __init__(self, loss_fn, params, run: RunConfig, n_workers: int,
                 device="cuda"):
        if not isinstance(run, RunConfig):
            raise TypeError(f"SimTrainer takes a repro_torch.api.RunConfig, "
                            f"got {type(run).__name__}")
        self.device = resolve_device(device)
        leaves = tree.leaves(params)
        for p in leaves:
            if p.device.type != self.device.type:
                raise ValueError(f"parameter on {p.device}, trainer on "
                                 f"{self.device}")
        self.loss_fn = loss_fn
        self.run_config = run
        self.mode = run.resolved_mode()
        self.n_workers = n_workers
        spec = _sim_spec(run, params, n_workers)
        self.exchange = R.build_exchange(spec)
        self.optimizer = opt.SGD(momentum=run.momentum)
        # online convergence health: needs per-leaf budgets, so slgs
        # (k_total over the concatenation) and dense are skipped
        self._health = (run.health_every > 0
                        and getattr(self.exchange, "ks", None) is not None)
        self._tiered = bool(R.get_exchange(self.mode).ef_tiers)
        # label payload for the lags/health/... grammar, in the same
        # flatten order as the stacked health_delta metric
        self.health_leaf_names = H.leaf_names(params)
        per_worker_like = tree.map(
            lambda p: Spec((n_workers,) + tuple(p.shape), torch.float32,
                           p.device), params)
        self.state = {
            "params": params,
            "ef": self.exchange.init(per_worker_like),
            "mom": spec.init_extra_state().get("mom", ()),
            "opt": self.optimizer.init(params),
            "step": 0,
        }

    def _lr(self, step: int) -> torch.Tensor:
        return torch.as_tensor(self.run_config.lr_at(step),
                               dtype=torch.float32, device=self.device)

    def _delta(self, updates, ef, step: int) -> dict:
        """Eq. 20 per leaf on ``acc = e + u`` (``delta_metric_tree``'s
        streams, one leaf's accumulator alive at a time)."""
        key = C.Key(17).fold_in(step)
        ks = tree.leaves(self.exchange.ks)
        deltas = []
        for i, (u, e) in enumerate(zip(updates, tree.leaves(ef))):
            acc = (e + u).reshape(u.shape[0], -1)
            deltas.append(assumption.delta_metric(acc, int(ks[i]),
                                                  key.fold_in(i)))
            del acc
        flat = torch.stack(deltas)
        return {"delta_max": flat.max(), "delta_mean": flat.mean(),
                "delta_per_leaf": flat}

    def _health_metrics(self, updates, ef, new_ef, mean) -> dict:
        """The health quantities of one step from the exchange's
        (mean, new residual) and its inputs (flat ``updates``, the old
        residual ``ef``), one leaf's aggregate alive at a time."""
        ex, p = self.exchange, self.n_workers
        ks = tree.leaves(ex.ks)
        means = tree.leaves(mean)
        if self._tiered:
            # lags_hier2: delta gates the slow OUTER wire.  The outer
            # residual is pod-replicated, so the leading-P sum
            # over-counts by n_inner; p_eff = pods
            n_in = max(1, int(getattr(ex, "n_inner", 1)))
            resid = tree.leaves(new_ef["outer"])
            out = {"health_ef_energy_inner": H.safe_ratio(
                H.sq_leaves(new_ef["inner"]),
                H.acc_sq_leaves(tree.leaves(ef["inner"]), updates))}
        else:
            n_in, resid = 1, tree.leaves(new_ef)
            out = {"health_ef_energy_flat": H.safe_ratio(
                H.sq_leaves(resid),
                H.acc_sq_leaves(tree.leaves(ef), updates))}
        deltas, energies = [], []
        for e, m, k in zip(resid, means, ks):
            e_sum = e.sum(0) / n_in
            d, en = H.delta_energy(e_sum, m, int(k), p // n_in)
            deltas.append(d)
            energies.append(en)
            del e_sum
        if self._tiered:
            out["health_ef_energy_outer"] = torch.stack(energies)
        delta = torch.stack(deltas)
        return out | {"health_delta": delta, "health_delta_max": delta.max()}

    def step(self, batch) -> dict:
        """One training step on ``batch`` (leaves (P, ...)); returns the
        metrics as device tensors: the mean loss over workers, lr and,
        under ``measure_delta``, the Eq. 20 metrics."""
        state = self.state
        params = state["params"]
        leaves, treedef = tree.flatten(params)
        lr = self._lr(state["step"])
        p_workers = self.n_workers
        mc = self.run_config.momentum_correction
        if mc:
            updates = tree.leaves(state["mom"])   # the velocity, in place
        else:
            updates = [torch.empty((p_workers,) + tuple(p.shape),
                                   dtype=torch.float32, device=p.device)
                       for p in leaves]
        losses = []
        for w in range(p_workers):
            loss, _aux = self.loss_fn(params, tree.map(lambda x: x[w], batch))
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for u, g in zip(updates, grads):
                    # u = lr * f32(g): cast first, so a bf16 gradient is
                    # scaled in f32 as in the reference (a 0-d f32 tensor
                    # times bf16 would stay bf16 in torch)
                    if mc:     # mom = mc·mom + lr·g, each product rounded
                        u[w].mul_(mc).add_(g.float().mul_(lr))
                    else:
                        u[w].copy_(g)
                        u[w].mul_(lr)
            del grads
            losses.append(loss.detach())
        metrics = {"loss": torch.stack(losses).mean(), "lr": lr}
        with torch.no_grad():
            if self.run_config.measure_delta and self.mode == "lags_dp":
                metrics.update(self._delta(updates, state["ef"],
                                           state["step"]))
            mean_update, new_ef = self.exchange.exchange(
                tree.unflatten(treedef, updates), state["ef"], None,
                key=self.run_config.key_at(state["step"]))
            if self._health:
                metrics.update(self._health_metrics(
                    updates, state["ef"], new_ef, mean_update))
            del updates
            deltas, new_opt = self.optimizer.update(mean_update,
                                                    state["opt"], params,
                                                    lr=1.0)
            del mean_update
            opt.apply_deltas(params, deltas)
        self.state = {"params": params, "ef": new_ef, "mom": state["mom"],
                      "opt": new_opt, "step": state["step"] + 1}
        return metrics

    def run(self, data_fn, n_steps: int, log_every: int = 0):
        """data_fn(step) -> per-worker batch tree with leading (P,) axis."""
        history = []
        for t in range(n_steps):
            metrics = self.step(data_fn(t))
            if log_every and (t % log_every == 0 or t == n_steps - 1):
                history.append({k: (v.tolist() if v.ndim else float(v))
                                for k, v in metrics.items()} | {"step": t})
        return history
