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
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device, tree
from repro_torch.api import registry as R
from repro_torch.api.config import RunConfig
from repro_torch.optim import optimizers as opt


class Spec:
    """Shape, dtype and device of a tensor not yet allocated (the
    counterpart of ``jax.ShapeDtypeStruct``)."""

    def __init__(self, shape, dtype, device):
        self.shape, self.dtype, self.device = tuple(shape), dtype, device


def _sim_spec(run: RunConfig, params, n_workers: int) -> R.ExchangeSpec:
    return R.ExchangeSpec(mode=run.resolved_mode(), params_like=params,
                          ratio=run.resolved_ratio(),
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
        unported = run.unported()
        if unported:
            raise NotImplementedError(f"not ported yet: {unported}")
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

    def step(self, batch) -> dict:
        """One training step on ``batch`` (leaves (P, ...)); returns the
        metrics as device tensors: the mean loss over workers and lr."""
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
        with torch.no_grad():
            mean_update, new_ef = self.exchange.exchange(
                tree.unflatten(treedef, updates), state["ef"], None)
            del updates
            deltas, new_opt = self.optimizer.update(mean_update,
                                                    state["opt"], params,
                                                    lr=1.0)
            del mean_update
            opt.apply_deltas(params, deltas)
        self.state = {"params": params, "ef": new_ef, "mom": state["mom"],
                      "opt": new_opt, "step": state["step"] + 1}
        return {"loss": torch.stack(losses).mean(), "lr": lr}

    def run(self, data_fn, n_steps: int, log_every: int = 0):
        """data_fn(step) -> per-worker batch tree with leading (P,) axis."""
        history = []
        for t in range(n_steps):
            metrics = self.step(data_fn(t))
            if log_every and (t % log_every == 0 or t == n_steps - 1):
                history.append({k: float(v) for k, v in metrics.items()}
                               | {"step": t})
        return history
