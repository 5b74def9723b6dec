"""Two-tier (intra-pod / cross-pod) LAGS planning: the port of
``repro.runtime.hier``.

The hierarchical train modes split the gradient exchange into an
intra-pod tier over the fast links (NVLink within a host) and a
cross-pod tier over the slow network between pods.
A flat schedule planned against a single α/β fit mis-prices both tiers;
this module plans them separately — each tier gets its own worker count
and its own fitted ``Hardware`` — and emits a ``schedule.HierSchedule``.

Both tiers of the emitted schedule are live planning dimensions:

  * ``lags_hier`` dense-reduces within the pod and ingests only the
    *outer* tier; its inner tier records what the intra-pod wire could
    afford.
  * ``lags_hier2`` executes BOTH tiers — its sparse intra-pod exchange
    takes the inner tier's per-leaf k's and its cross-pod exchange takes
    the outer tier's (``repro_torch.api.registry.resolve_schedule_ks``).
    When a contended intra-pod wire cannot hide a leaf the inner plan
    goes sparse and the train step actually runs it.

The inner tier still usually plans dense (ratio 1): on a healthy
intra-pod wire the exchange hides behind backward compute, which is the
same Eq. 18 layer-wise tradeoff the paper makes per layer, applied per
tier.

Convergence is covered by the paper's Lemma 1 (any partition of the
gradient into pieces) plus the k-contraction argument of Alistarh et
al. (arXiv 1809.10505), which licenses per-tier — and, online, per-window
— changes of k without losing the guarantee.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.autotune import costfit, planner
from repro_torch.autotune import schedule as S
from repro_torch.core import comm_model as cm


def tier_hardware(samples: Sequence, base: cm.Hardware,
                  name: str) -> cm.Hardware:
    """Fitted wire (α, β) on ``base``'s compute spec for one tier.

    Falls back to ``base``'s wire constants when the tier produced no
    usable samples (single-worker tier, or a probe that returned [])."""
    try:
        alpha, beta = costfit.fit_alpha_beta(samples)
    except ValueError:
        alpha, beta = base.alpha, base.beta
    return cm.Hardware(name=name, alpha=alpha, beta=beta,
                       flops=base.flops, hbm_bw=base.hbm_bw)


def plan_hier_schedule(leaves: Sequence, *, p_inner: int, p_outer: int,
                       hw_inner: cm.Hardware, hw_outer: cm.Hardware,
                       arch: str = "", shape: str = "",
                       c_upper: float = 1000.0,
                       efficiency: float = 0.45,
                       train_mode: str = "lags_hier") -> S.HierSchedule:
    """Eq. 18 per leaf, solved once per tier against that tier's fit.

    ``leaves`` is the same backprop-ordered ``profiler.LeafSample``
    sequence flat planning uses; both tiers see the same measured compute
    budgets (each tier's exchange must hide behind the same backward
    compute).  ``train_mode`` stamps the provenance both tiers carry
    ("lags_hier" or "lags_hier2" — the same two-wire pricing feeds
    either).  On a single-pod mesh ``p_outer == 1`` degenerates the
    outer tier to all-dense plans (no cross-pod wire, zero comm time
    satisfies every budget) — matching the train step's single-pod
    behaviour of compressor+EF with no sparse comm."""
    inner = planner.plan_schedule(leaves, p=p_inner, hw=hw_inner, arch=arch,
                                  shape=shape, c_upper=c_upper,
                                  efficiency=efficiency,
                                  train_mode=train_mode)
    outer = planner.plan_schedule(leaves, p=p_outer, hw=hw_outer, arch=arch,
                                  shape=shape, c_upper=c_upper,
                                  efficiency=efficiency,
                                  train_mode=train_mode)
    return S.HierSchedule(arch=arch, shape=shape,
                          inner=dataclasses.replace(inner, tier="inner"),
                          outer=dataclasses.replace(outer, tier="outer"))


def _tier_comm_time(d: int, ratio: float, p: int, hw: cm.Hardware) -> float:
    """One tier's per-leaf exchange time (``planner.leaf_comm_time``);
    0 for a single-worker tier, which has no wire at all."""
    if p <= 1:
        return 0.0
    return planner.leaf_comm_time(d, ratio, p, hw)


def predict_hier_iteration(leaves: Sequence, inner: "S.Schedule | None",
                           outer: S.Schedule, *, p_inner: int, p_outer: int,
                           hw_inner: cm.Hardware, hw_outer: cm.Hardware,
                           t_forward: float) -> dict:
    """Two-tier analogue of ``planner.predict_iteration``.

    Per leaf, the exchange cost is the intra-pod tier (priced on its
    fit) plus the cross-pod tier (its own fit), pipelined against the same
    backward timeline.  ``inner=None`` prices a dense intra-pod
    reduction on every leaf — the live behaviour when no inner plan is
    installed (static baseline, or a flat schedule).  Returns the same
    fields as ``planner.predict_iteration``."""
    rin = (None if inner is None
           else {lp.name: lp.ratio for lp in inner.leaves})
    rout = {lp.name: lp.ratio for lp in outer.leaves}
    t_b, t_c = [], []
    for leaf in leaves:
        t_b.append(leaf.t_backward)
        c_in = 1.0 if rin is None else rin[leaf.name]
        t_c.append(_tier_comm_time(leaf.d, c_in, p_inner, hw_inner)
                   + _tier_comm_time(leaf.d, rout[leaf.name], p_outer,
                                     hw_outer))
    t_lags = cm.iteration_time_lags(t_forward, t_b, t_c)
    t_comm = sum(t_c)
    t_back = sum(t_b)
    exposed = max(0.0, t_lags - t_forward - t_back)
    return {"t_lags": t_lags,
            "t_slgs": cm.iteration_time_slgs(t_forward, t_back, t_comm),
            "t_comm": t_comm, "t_backward": t_back, "t_forward": t_forward,
            "exposed_comm": exposed,
            "overlap": 1.0 - exposed / t_comm if t_comm > 0 else 1.0}
