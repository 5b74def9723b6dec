"""Composable re-plan triggers for ``runtime.ReplanController`` (a copy
of ``repro.observe.triggers``; the fingerprint fit is the port's
``autotune.costfit``).

``ReplanController._due()`` used to be one hard-coded modulo; it is now
the OR of a trigger list, each trigger answering "should this step
re-plan?" from the :class:`TriggerContext` the controller hands it:

  * :class:`CadenceTrigger` — every N steps; the default trigger set is
    ``(CadenceTrigger(rcfg.replan_every),)``, which preserves the
    pre-observe semantics exactly.
  * :class:`AnomalyTrigger` — wraps a
    :class:`~repro_torch.observe.anomaly.StepTimeAnomalyDetector` over the
    telemetry step window: a wire regression re-plans *now* instead of
    at the next cadence boundary.
  * :class:`FingerprintTrigger` — cache invalidation: re-fits (α, β)
    from the recent collective-sample window and fires when the live
    wire has drifted from the fit recorded in the schedule's
    ``hardware`` fingerprint (``Schedule.hardware_drift``).  Silent
    while no schedule is installed or while the window cannot support a
    fit.
  * :class:`HealthTrigger` — model/theory health: fires while a
    :class:`~repro_torch.observe.health.HealthMonitor` holds a pending
    convergence alarm (Assumption-1 delta over threshold, or drifting),
    so an over-aggressive compression schedule re-plans *now* instead
    of at the next cadence boundary.

Triggers are stateful; the controller calls :meth:`notify_replan` after
every re-plan (swapped or hysteresis-rejected) so detectors can re-arm,
and persists ``state_dict()``-capable triggers through its checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

from repro_torch.observe.anomaly import AnomalyConfig, StepTimeAnomalyDetector


@dataclasses.dataclass(frozen=True)
class TriggerContext:
    """What the controller knows at a step boundary."""
    step: int
    telemetry: Any           # runtime.Telemetry
    schedule: Any            # live Schedule/HierSchedule or None
    mode: str


@runtime_checkable
class ReplanTrigger(Protocol):
    """``due`` may be stateful (consume telemetry); ``notify_replan`` is
    called after every re-plan the trigger set caused."""
    name: str

    def due(self, ctx: TriggerContext) -> bool: ...

    def notify_replan(self, ctx: TriggerContext, event) -> None: ...


class CadenceTrigger:
    """Fixed cadence: due every ``every`` steps (0 = never)."""
    name = "cadence"

    def __init__(self, every: int):
        self.every = int(every)

    def due(self, ctx: TriggerContext) -> bool:
        return self.every > 0 and ctx.step % self.every == 0

    def notify_replan(self, ctx, event) -> None:
        pass


class AnomalyTrigger:
    """Due when the step-time detector flags a regression."""
    name = "anomaly"

    def __init__(self, detector: StepTimeAnomalyDetector | None = None,
                 cfg: AnomalyConfig | None = None):
        if detector is not None and cfg is not None:
            raise ValueError("pass detector= or cfg=, not both")
        self.detector = detector or StepTimeAnomalyDetector(cfg)
        self.last: Any = None     # most recent Anomaly (diagnostics)

    def due(self, ctx: TriggerContext) -> bool:
        anomaly = self.detector.observe(ctx.telemetry.step_samples())
        if anomaly is not None:
            self.last = anomaly
        return anomaly is not None

    def notify_replan(self, ctx, event) -> None:
        # the re-plan answered the detection (and a swap recompiles the
        # step): start a fresh epoch so the new normal is the baseline
        self.detector.reset()

    def state_dict(self) -> dict:
        return {"detector": self.detector.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.detector.load_state_dict(state.get("detector", {}))


class FingerprintTrigger:
    """Due when the live (α, β) fit drifts from ``schedule.hardware``.

    The fit comes from the newest ``latest`` samples of the telemetry
    comm ring (newest-last ordering, pinned by test) — no fresh probe is
    issued just to check the fingerprint.  For hierarchical schedules
    EVERY tier is checked against its own fingerprint: inner-tier (ICI)
    samples are fitted against the inner tier's recorded (α, β) and
    outer-tier (DCN) samples against the outer's, so an ICI-only
    degradation fires here instead of waiting on the anomaly path.
    Unlabelled samples (raw probe batches; attributed traces carry tier
    labels) default to the outer tier, which preserves the flat-schedule
    behaviour.  ``last_tier`` records which tier fired (diagnostics).
    """
    name = "fingerprint"

    def __init__(self, drift: float = 0.5, latest: int = 32):
        self.drift = float(drift)
        self.latest = int(latest)
        self.last_tier: str | None = None

    @staticmethod
    def _tier_samples(samples, tier: str) -> list:
        labelled = [s for s in samples
                    if getattr(s, "label", "").startswith(f"{tier}/")]
        if labelled or tier != "outer":
            return labelled
        # unlabelled rings (probe batches) check the sparse outer wire
        return [s for s in samples
                if not getattr(s, "label", "").startswith(("inner/",))]

    def due(self, ctx: TriggerContext) -> bool:
        sched = ctx.schedule
        drift_fn = getattr(sched, "hardware_drift", None)
        if drift_fn is None:       # no schedule live / duck-typed plan
            return False
        from repro_torch.autotune import costfit
        samples = ctx.telemetry.comm_samples(latest=self.latest)
        tiers = getattr(sched, "tiers", None)
        for tier in (tiers if tiers is not None else ("outer",)):
            try:
                alpha, beta = costfit.fit_alpha_beta(
                    self._tier_samples(samples, tier))
            except ValueError:
                continue           # tier window cannot support a fit
            drifted = (drift_fn(alpha, beta, tier=tier)
                       if tiers is not None else drift_fn(alpha, beta))
            if drifted > self.drift:
                self.last_tier = tier
                return True
        return False

    def notify_replan(self, ctx, event) -> None:
        pass


class HealthTrigger:
    """Due while the convergence-health monitor holds a pending alarm.

    The monitor is fed elsewhere (``api.Session.run`` at the health
    cadence — :class:`TriggerContext` carries no health data); this
    trigger only polls it, so it composes with the same monitor emitting
    ``health_alarm`` events.  ``notify_replan`` re-arms the monitor: the
    re-plan answered the alarm, and the new schedule is a new baseline.
    """
    name = "health"

    def __init__(self, monitor):
        self.monitor = monitor     # repro_torch.observe.health.HealthMonitor
        self.last: Any = None      # most recent consumed alarm payload

    def due(self, ctx: TriggerContext) -> bool:
        if not self.monitor.alarming:
            return False
        self.last = self.monitor.consume()
        return True

    def notify_replan(self, ctx, event) -> None:
        self.monitor.reset()

    def state_dict(self) -> dict:
        return {"monitor": self.monitor.state_dict(), "last": self.last}

    def load_state_dict(self, state: dict) -> None:
        self.monitor.load_state_dict(state.get("monitor", {}))
        self.last = state.get("last")


def default_triggers(replan_every: int) -> tuple:
    """The pre-observe controller behaviour: cadence only."""
    return (CadenceTrigger(replan_every),)
