"""Convergence-health quantities: the paper's theory, observed online
(the port of ``repro.observe.health``).

The paper's guarantee rests on Assumption 1 (Eq. 20): per layer,

    delta^(l) = || sum_p acc^p - sum_p TopK(acc^p, k) ||^2
              / E|| sum_p acc^p - RandK(sum_p acc^p, k) ||^2  <=  1

where ``acc = e + u`` is the EF-accumulated gradient.  The offline bench
(``benchmarks/bench_assumption.py`` via ``core.assumption``) measures it
by re-running the compressor on materialized per-worker accumulators;
this module computes the *same* quantity from what the live exchange
already returns, so a real run can watch its own assumption:

  * every EF exchange obeys ``acc_p = e_new_p + sel_p`` with
    ``sum_p sel_p = p * mean`` — so the TopK numerator is
    ``||sum_p e_new_p||^2`` and the aggregated accumulator is
    ``sum_p acc_p = sum_p e_new_p + p * mean``, both recoverable from
    the returned ``(mean, new_ef)`` without re-compressing anything;
  * the RandK denominator uses its closed-form expectation
    ``(1 - k/d) ||agg||^2`` (Stich et al. 2018) — the same value
    ``core.assumption.delta_metric(..., n_rand=0)`` computes, which is
    the oracle the property tests compare against.

On the simulation surface (leading-P leaves) the numerator costs one
extra reduction (``e_new.sum(0)``).  On the distributed surface
``sum_w e_new`` needs one dense all-reduce per leaf — cross terms of
``||sum_w e||^2`` are not recoverable from per-worker scalars — which is
why everything here is gated behind ``health_every > 0`` when the step
is built (no key and no work when off).

The helpers return f32 tensors on the inputs' device: per-leaf vectors
stacked in ``tree.leaves`` order, the reference's ``jax.tree.leaves``
order.

Also here: per-leaf EF energy retention ``||e_new||^2 / ||acc||^2`` (how
much gradient energy the residual is holding back, per tier layout), the
async1 staleness gap ``||u_t - u_{t-1}|| / ||u_t||``, and the host-side
:class:`HealthMonitor` that turns a delta_max stream into ``health_alarm``
events — by absolute threshold (immediate) and by drift through a
duck-typed :class:`~repro.observe.anomaly.StepTimeAnomalyDetector` fed
``(step, t_step=delta_max)`` samples.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree
from repro_torch.observe.anomaly import AnomalyConfig, StepTimeAnomalyDetector

#: Denominator floor: a vanishing aggregate (perfect worker cancellation
#: or k = d, where the closed form is exactly zero) reads as delta = 0
#: when the residual is zero too, never as inf/nan.
EPS = 1e-30


# ---------------------------------------------------------------------------
# device-side helpers (plain torch; no autograd)
# ---------------------------------------------------------------------------

def sq_norm(x: torch.Tensor) -> torch.Tensor:
    """``||x||^2`` in f32 (bf16 residuals square-sum in full precision),
    without a squared copy of ``x``."""
    return torch.linalg.vector_norm(x, dtype=torch.float32).square()


def sq_leaves(tree_) -> torch.Tensor:
    """Per-leaf ``||x||^2`` stacked in flatten order, shape (L,).
    Leading worker axes (sim surface) fold into the sum — the result is
    then ``sum_p ||x_p||^2`` per leaf."""
    return torch.stack([sq_norm(x) for x in tree.leaves(tree_)])


def safe_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / torch.clamp_min(den, EPS)


def _frac(d: int, k: int) -> float:
    """The closed-form RandK factor ``1 - k/d`` of Eq. 20's denominator."""
    return 1.0 - min(int(k), d) / d


def delta_online(e_sum: torch.Tensor, agg: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Eq.-20 delta for one leaf from the worker-summed new EF residual
    ``e_sum = sum_p e_new_p`` and the aggregated accumulator
    ``agg = e_sum + p * mean``; closed-form RandK denominator."""
    frac = _frac(e_sum.numel(), k)
    return safe_ratio(sq_norm(e_sum), frac * sq_norm(agg))


def delta_leaves(e_sum_tree, agg_tree, ks) -> torch.Tensor:
    """Per-leaf :func:`delta_online` over a tree, shape (L,) in flatten
    order (matches :func:`leaf_names`)."""
    flat_e, treedef = tree.flatten(e_sum_tree)
    flat_a = tree.flatten_up_to(treedef, agg_tree)
    flat_k = tree.flatten_up_to(treedef, ks)
    return torch.stack([delta_online(e, a, int(k))
                        for e, a, k in zip(flat_e, flat_a, flat_k)])


def delta_energy(e_sum: torch.Tensor, mean: torch.Tensor, k: int,
                 p: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One leaf's (delta, aggregate energy retention) from the
    worker-summed residual and the exchanged mean: ``agg = e_sum + p *
    mean`` (the EF exchange identity, built for this leaf only), delta =
    ``||e_sum||^2 / ((1 - k/d) ||agg||^2)`` and energy =
    ``||e_sum||^2 / ||agg||^2``."""
    agg = e_sum + float(p) * mean
    num, den = sq_norm(e_sum), sq_norm(agg)
    del agg
    return (safe_ratio(num, _frac(e_sum.numel(), k) * den),
            safe_ratio(num, den))


def delta_leaves_from_mean(e_sum_tree, mean_tree, ks,
                           p: int) -> torch.Tensor:
    """:func:`delta_leaves` with ``agg`` reconstructed as
    ``e_sum + p * mean`` (the EF exchange identity), one leaf's
    aggregate alive at a time."""
    flat_e, treedef = tree.flatten(e_sum_tree)
    flat_m = tree.flatten_up_to(treedef, mean_tree)
    flat_k = tree.flatten_up_to(treedef, ks)
    return torch.stack([delta_energy(e, m, int(k), p)[0]
                        for e, m, k in zip(flat_e, flat_m, flat_k)])


def acc_sq_leaves(e_tree, u_tree) -> torch.Tensor:
    """Per-leaf ``||e + u||^2`` (the accumulator before selection), shape
    (L,), one leaf's accumulator alive at a time."""
    flat_e, treedef = tree.flatten(e_tree)
    flat_u = tree.flatten_up_to(treedef, u_tree)
    out = []
    for e, u in zip(flat_e, flat_u):
        acc = e + u
        out.append(sq_norm(acc))
        del acc
    return torch.stack(out)


def energy_leaves(num_tree, den_tree) -> torch.Tensor:
    """Per-leaf energy-retention ratio ``||num||^2 / ||den||^2``, shape
    (L,).  With leading-P leaves this is the local form
    ``sum_p ||e_new_p||^2 / sum_p ||acc_p||^2``."""
    return safe_ratio(sq_leaves(num_tree), sq_leaves(den_tree))


def staleness_gap(u_now_sq: torch.Tensor,
                  diff_sq: torch.Tensor) -> torch.Tensor:
    """async1 staleness ``||u_t - u_{t-1}|| / ||u_t||`` from the two
    squared norms (callers all-reduce the squares across workers first)."""
    return torch.sqrt(safe_ratio(diff_sq, u_now_sq))


# ---------------------------------------------------------------------------
# host-side naming (matches the flatten order of the stacked vectors)
# ---------------------------------------------------------------------------

def leaf_names(tree_) -> list[str]:
    """Slash-joined leaf paths in flatten order — the ``label`` payload of
    the ``lags/health/...`` grammar."""
    return tree.leaf_paths(tree_)


# ---------------------------------------------------------------------------
# host-side monitor: delta_max stream -> health_alarm
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HealthSample:
    """Duck-typed for :class:`StepTimeAnomalyDetector`: ``t_step`` holds
    delta_max, not seconds."""
    step: int
    t_step: float


class HealthMonitor:
    """Watches the per-fence delta_max stream for divergence.

    Two alarm paths, both latched fire-once until :meth:`reset` (the
    :class:`~repro.observe.triggers.HealthTrigger` resets on re-plan):

      * ``threshold`` — absolute ``delta_max > threshold`` fires on the
        very first offending sample (a CI run of 4 steps cannot wait for
        a median window);
      * drift — the detector's robust change-point over the recent
        window, for long runs where delta creeps without crossing an
        absolute line.

    An alarm stays pending until :meth:`consume` (the trigger) or the
    next :meth:`observe` by an event emitter reads it via the return
    value; JSON-clean ``state_dict`` for checkpoint round-trips.
    """

    def __init__(self, *, threshold: float | None = None,
                 detector: StepTimeAnomalyDetector | None = None,
                 cfg: AnomalyConfig | None = None):
        if detector is not None and cfg is not None:
            raise ValueError("pass detector= or cfg=, not both")
        self.threshold = None if threshold is None else float(threshold)
        self.detector = detector or StepTimeAnomalyDetector(cfg)
        self._threshold_fired = False
        self._pending: dict | None = None
        self.last_alarm: dict | None = None

    def observe(self, step: int, delta_max: float) -> dict | None:
        """Feed one delta_max sample; returns a *new* alarm payload
        (JSON-clean) or None."""
        s = HealthSample(int(step), float(delta_max))
        alarm: dict | None = None
        if (self.threshold is not None and not self._threshold_fired
                and s.t_step > self.threshold):
            self._threshold_fired = True
            alarm = {"reason": "threshold", "step": s.step,
                     "delta_max": s.t_step, "threshold": self.threshold}
        anomaly = self.detector.observe([s])
        if anomaly is not None and alarm is None:
            alarm = {"reason": "drift", "step": int(anomaly.step),
                     "delta_max": float(anomaly.t_recent),
                     "score": float(anomaly.score),
                     "ref": float(anomaly.t_ref)}
        if alarm is not None:
            self._pending = dict(alarm)
            self.last_alarm = dict(alarm)
        return alarm

    @property
    def alarming(self) -> bool:
        """An alarm is pending (fired, not yet consumed by a trigger)."""
        return self._pending is not None

    def consume(self) -> dict | None:
        """Pop the pending alarm (the trigger's read)."""
        pending, self._pending = self._pending, None
        return pending

    def reset(self) -> None:
        """Re-arm after a re-plan: the new schedule is a new baseline."""
        self.detector.reset()
        self._threshold_fired = False
        self._pending = None

    # -- checkpoint round-trip (JSON-clean) --------------------------------
    def state_dict(self) -> dict:
        return {"detector": self.detector.state_dict(),
                "threshold_fired": self._threshold_fired,
                "pending": self._pending,
                "last_alarm": self.last_alarm}

    def load_state_dict(self, state: dict) -> None:
        self.detector.load_state_dict(state.get("detector", {}))
        self._threshold_fired = bool(state.get("threshold_fired", False))
        pending = state.get("pending")
        self._pending = None if pending is None else dict(pending)
        last = state.get("last_alarm")
        self.last_alarm = None if last is None else dict(last)
