"""Eq. 18 over a *calibrated* cost model: measured profile -> Schedule,
the port of ``repro.autotune.planner``.

``core.adaptive.choose_ratio`` implements the paper's selection rule
against analytic α–β constants; this module runs the same rule but with

  * per-leaf compute budgets taken from **measured** backward timings
    (``profiler.LeafSample.t_backward``) instead of FLOP estimates, and
  * a ``Hardware`` whose α/β/FLOPs were **fitted** from profiled samples
    (``costfit.fit_hardware``) instead of hard-coded constants,

and adds the dense fallback: when even the capped ratio c_u cannot hide
the exchange AND a dense all-reduce would be no slower than the best
sparse exchange, compression cannot win — the leaf is planned dense
(c=1), which by Cor. 2 is also the best choice for convergence.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.autotune import schedule as S
from repro_torch.core import adaptive, comm_model as cm


def plan_leaf(d: int, t_budget: float, p: int, hw: cm.Hardware,
              c_upper: float = 1000.0) -> float:
    """Ratio for one leaf: Eq. 18 with the c_u cap + dense fallback."""
    c = adaptive.choose_ratio(d, t_budget, p, hw, c_upper)
    if c <= 1.0:
        return c
    t_sparse = (cm.sparse_allgather_time(d, c, p, hw)
                + adaptive.sparsification_overhead(d, hw))
    if t_sparse <= t_budget:
        return c
    # nothing fits the budget; sparse only earns its overhead if it still
    # beats the dense wire time, otherwise plan dense
    t_dense = cm.allreduce_time(4 * d, p, hw)
    return c if t_sparse < t_dense else 1.0


def plan_schedule(leaves: Sequence, p: int, hw: cm.Hardware, *,
                  arch: str = "", shape: str = "", c_upper: float = 1000.0,
                  efficiency: float = 0.45,
                  train_mode: str = "lags_dp") -> S.Schedule:
    """Solve Eq. 18 per leaf over measured budgets.

    ``leaves`` is a backprop-ordered sequence of objects with ``name``,
    ``d``, ``backward_flops`` and ``t_backward`` attributes
    (``profiler.LeafSample``).  Leaf l's exchange must hide behind the
    backward compute of the next leaf in backprop order (t_comp^(l-1) in
    the paper); the measured ``t_backward`` of that leaf is the budget.
    Leaves profiled without a timing (``t_backward <= 0``) fall back to
    the analytic FLOPs/MFU estimate — so a purely analytic profile plans
    exactly like ``core.adaptive.choose_ratios``.
    """
    plans = []
    for i, leaf in enumerate(leaves):
        if i + 1 < len(leaves):
            nxt = leaves[i + 1]
            budget = (nxt.t_backward if nxt.t_backward > 0.0 else
                      cm.layer_backward_time(nxt.backward_flops, hw,
                                             efficiency))
        else:
            budget = 0.0  # first layer of the net: nothing left to hide behind
        c = plan_leaf(leaf.d, budget, p, hw, c_upper)
        k = max(1, int(round(leaf.d / c)))
        plans.append(S.LeafPlan(name=leaf.name, d=leaf.d, ratio=float(c),
                                k=k, t_budget=float(budget)))
    return S.Schedule(arch=arch, shape=shape, n_workers=int(p),
                      hardware={"name": hw.name, "alpha": hw.alpha,
                                "beta": hw.beta, "flops": hw.flops,
                                "hbm_bw": hw.hbm_bw},
                      leaves=tuple(plans), train_mode=train_mode)


def leaf_comm_time(d: int, ratio: float, p: int, hw: cm.Hardware) -> float:
    """Per-leaf exchange time under a planned ratio: dense all-reduce at
    ratio <= 1, sparse all-gather + selection overhead otherwise.  The
    ONE pricing every predictor uses: flat ``predict_iteration``,
    ``runtime.hier.predict_hier_iteration`` and the wave planner
    (``pipeline.waves.plan_waves``)."""
    if ratio <= 1.0:
        return cm.allreduce_time(4 * d, p, hw)
    return (cm.sparse_allgather_time(d, ratio, p, hw)
            + adaptive.sparsification_overhead(d, hw))


def predict_iteration(leaves: Sequence, sched: S.Schedule, p: int,
                      hw: cm.Hardware, t_forward: float) -> dict:
    """Predicted wall-clock for one iteration under the planned schedule.

    Returns the pipelined LAGS time (Eq. in ``cm.iteration_time_lags``),
    the serialized SLGS time, and the communication total, to compare
    against measured steps."""
    ratio = {lp.name: lp.ratio for lp in sched.leaves}
    t_b, t_c = [], []
    for leaf in leaves:
        t_b.append(leaf.t_backward)
        t_c.append(leaf_comm_time(leaf.d, ratio[leaf.name], p, hw))
    t_lags = cm.iteration_time_lags(t_forward, t_b, t_c)
    t_comm = sum(t_c)
    t_back = sum(t_b)
    t_slgs = cm.iteration_time_slgs(t_forward, t_back, t_comm)
    exposed = max(0.0, t_lags - t_forward - t_back)
    return {"t_lags": t_lags, "t_slgs": t_slgs, "t_comm": t_comm,
            "t_backward": t_back, "t_forward": t_forward,
            "exposed_comm": exposed,
            "overlap": 1.0 - exposed / t_comm if t_comm > 0 else 1.0}
