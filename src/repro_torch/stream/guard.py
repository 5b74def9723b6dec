"""Rollout guard, as ``repro.stream.guard`` has it: quality change-point
detection over the weight stream.

The median/MAD change-point detector that flags wire regressions in
training (``observe.anomaly.StepTimeAnomalyDetector``) flags quality
regressions in serving: each candidate update is scored with a held-out
negative log-likelihood, and the detector watches the (version, NLL)
series as it watches (step, seconds).  A training run drifts the NLL
slowly down: quiet.  A poisoned packet (diverged run, corrupted
artifact, wrong stream) jumps it: the guard fires once, the subscriber
keeps the last-good parameters live, and the stream stays halted until
an operator :meth:`RolloutGuard.resume`\\ s it.

Defaults differ from the step-time tuning: ``recent=1`` (a single bad
version vetoes; the eval batch is fixed and the NLL deterministic) and
``warmup=0`` (version 1 is a real sample).
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.observe.anomaly import (Anomaly, AnomalyConfig,
                                         StepTimeAnomalyDetector)


@dataclasses.dataclass(frozen=True)
class QualitySample:
    """Duck-typed for the detector: ``step`` is the packet version and
    ``t_step`` the held-out NLL."""
    step: int
    t_step: float


def default_guard_config() -> AnomalyConfig:
    return AnomalyConfig(warmup=0, recent=1, min_history=3, z=4.0,
                         min_rel=0.1, mad_floor_rel=0.02, window=64)


def quality_probe(cfg, batch, *, chunk: int = 64, loss_chunk: int = 64):
    """``eval_fn(params) -> float``: the mean next-token NLL ("ce") of a
    fixed held-out batch ({"tokens", "labels"} on the parameters'
    device), without gradients."""
    from repro_torch.models import transformer as T

    @torch.no_grad()
    def nll(params):
        _, parts = T.loss_fn(params, cfg, batch, chunk=chunk, remat=False,
                             loss_chunk=loss_chunk)
        return float(parts["ce"])

    return nll


class RolloutGuard:
    """Scores candidate parameter updates; halts the stream on a
    regression.

    ``eval_fn(params) -> float``, lower is better (an NLL; build one with
    :func:`quality_probe`).  ``observe`` returns the triggering
    :class:`Anomaly` (and latches ``halted``) or None; the subscriber then
    pins its last-good version via :meth:`pin`."""

    def __init__(self, eval_fn, cfg: AnomalyConfig | None = None,
                 history: int = 64, metrics=None, events=None):
        from repro_torch.observe import events as OE
        from repro_torch.observe import metrics as OM
        self.eval_fn = eval_fn
        self.detector = StepTimeAnomalyDetector(cfg or
                                                default_guard_config())
        self.samples: collections.deque[QualitySample] = \
            collections.deque(maxlen=int(history))
        self.halted = False
        self.pinned_version: int | None = None
        self.anomaly: Anomaly | None = None
        reg = metrics if metrics is not None else OM.default_registry()
        self._events = events if events is not None else OE.default_events()
        self._m_nll = reg.gauge(
            "guard_nll", "Held-out NLL of the last scored candidate.")
        self._m_evals = reg.counter(
            "guard_evals_total", "Candidate updates scored.")
        self._m_trips = reg.counter(
            "guard_trips_total", "Quality change-point firings (halts).")

    def observe(self, version: int, params) -> Anomaly | None:
        """Score one candidate (version, params); fire on a quality jump."""
        nll = float(self.eval_fn(params))
        self.samples.append(QualitySample(step=int(version), t_step=nll))
        self._m_nll.set(nll)
        self._m_evals.inc()
        anomaly = self.detector.observe(self.samples)
        if anomaly is not None:
            self.anomaly = anomaly
            self.halted = True
            self._m_trips.inc()
            self._events.emit("guard_trip", step=int(version), nll=nll,
                              score=float(anomaly.score),
                              nll_recent=float(anomaly.t_recent),
                              nll_ref=float(anomaly.t_ref))
        return anomaly

    def pin(self, version: int) -> None:
        """Record the last-good version (the subscriber's live params)."""
        self.pinned_version = int(version)
        self.halted = True
        self._events.emit("guard_pin", step=int(version))

    def allow(self, version: int | None = None) -> bool:
        return not self.halted

    @property
    def last_nll(self) -> float | None:
        return self.samples[-1].t_step if self.samples else None

    def resume(self) -> None:
        """Operator override after a halt (e.g. after a resync): unlatch
        and re-base the detector on the next samples."""
        self._events.emit("guard_resume",
                          step=int(self.pinned_version or 0))
        self.halted = False
        self.anomaly = None
        self.pinned_version = None
        self.samples.clear()
        self.detector.reset()
