"""Step-time regression detection over the telemetry window (a copy of
``repro.observe.anomaly``, stdlib only).

A fixed re-plan cadence reacts to a wire regression only at the next
boundary — up to ``replan_every - 1`` degraded steps late.  The detector
here watches the same ``runtime.Telemetry`` step samples the controller
already collects and flags a *change point*: the median of the most
recent ``recent`` samples jumping above the robust (median/MAD) spread
of the preceding history.

Design points, each pinned by a test in ``tests/test_observe.py``:

  * **robust score** — median/MAD, not mean/std: one noisy fence sample
    must neither trigger nor mask a detection.  MAD is floored at a
    fraction of the reference median (``mad_floor_rel``) so a perfectly
    quiet window (the deterministic fake-trace backend has zero noise)
    cannot produce an infinite score from measurement-identical steps.
  * **warmup masking** — the first ``warmup`` samples after construction
    or :meth:`reset` are discarded: they absorb the compile spike of a
    fresh (or re-built) train step, which is a one-off, not a
    regression.
  * **fire exactly once** — a detection latches until :meth:`reset`.
    The controller resets on every re-plan, so a regression produces one
    re-plan; if the degraded wire persists, post-reset history re-bases
    on the new normal and stays quiet.
  * **checkpointable** — :meth:`state_dict` / :meth:`load_state_dict`
    are JSON-clean so the controller can persist detector state through
    ``checkpoint.io`` alongside its own.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Sequence


def _median(xs: Sequence[float]) -> float:
    ys = sorted(xs)
    n = len(ys)
    mid = n // 2
    return ys[mid] if n % 2 else 0.5 * (ys[mid - 1] + ys[mid])


@dataclasses.dataclass(frozen=True)
class AnomalyConfig:
    """Knobs of the change-point score."""
    warmup: int = 2          # post-reset samples to discard (compile spike)
    recent: int = 3          # change-point window (newest samples)
    min_history: int = 4     # reference samples required before scoring
    z: float = 6.0           # robust-z threshold on the recent median
    min_rel: float = 0.2     # AND: recent median >= (1+min_rel) * reference
    mad_floor_rel: float = 0.02   # MAD floor as a fraction of the reference
    window: int = 64         # history ring capacity


@dataclasses.dataclass(frozen=True)
class Anomaly:
    """One detection: the step it latched at and the evidence."""
    step: int
    score: float
    t_recent: float      # median seconds/step over the recent window
    t_ref: float         # reference median it regressed from


class StepTimeAnomalyDetector:
    """Feed it ``Telemetry.step_samples()``; it remembers what it has
    already consumed, so calling :meth:`observe` every step is cheap and
    idempotent over the unchanged prefix."""

    def __init__(self, cfg: AnomalyConfig | None = None):
        self.cfg = cfg or AnomalyConfig()
        self._hist: collections.deque[tuple[int, float]] = \
            collections.deque(maxlen=self.cfg.window)
        self._last_seen = -1
        self._to_skip = self.cfg.warmup
        self._fired_at: int | None = None

    @property
    def fired(self) -> bool:
        return self._fired_at is not None

    def observe(self, samples: Sequence) -> Anomaly | None:
        """Consume unseen ``StepSample``\\ s; return a *new* detection or
        None (a latched prior detection also returns None — fire once)."""
        for s in samples:
            if s.step <= self._last_seen:
                continue
            self._last_seen = int(s.step)
            if self._to_skip > 0:
                self._to_skip -= 1
                continue
            self._hist.append((int(s.step), float(s.t_step)))
        return self._check()

    def _check(self) -> Anomaly | None:
        cfg = self.cfg
        if self._fired_at is not None:
            return None
        if len(self._hist) < cfg.min_history + cfg.recent:
            return None
        ts = [t for _, t in self._hist]
        ref, rec = ts[:-cfg.recent], ts[-cfg.recent:]
        med_ref = _median(ref)
        mad = _median([abs(t - med_ref) for t in ref])
        scale = max(mad, cfg.mad_floor_rel * med_ref, 1e-12)
        med_rec = _median(rec)
        score = (med_rec - med_ref) / scale
        if score > cfg.z and med_rec > med_ref * (1.0 + cfg.min_rel):
            self._fired_at = self._hist[-1][0]
            return Anomaly(step=self._fired_at, score=float(score),
                           t_recent=float(med_rec), t_ref=float(med_ref))
        return None

    def reset(self) -> None:
        """New epoch (post re-plan / recompile): unlatch, drop history,
        re-arm the warmup mask.  The consumed-sample cursor survives so
        pre-reset samples are never re-ingested."""
        self._hist.clear()
        self._to_skip = self.cfg.warmup
        self._fired_at = None

    # -- checkpoint round-trip (JSON-clean) --------------------------------
    def state_dict(self) -> dict:
        return {"hist": [[s, t] for s, t in self._hist],
                "last_seen": self._last_seen,
                "to_skip": self._to_skip,
                "fired_at": self._fired_at}

    def load_state_dict(self, state: dict) -> None:
        self._hist.clear()
        self._hist.extend((int(s), float(t)) for s, t in state.get("hist", []))
        self._last_seen = int(state.get("last_seen", -1))
        self._to_skip = int(state.get("to_skip", self.cfg.warmup))
        fired = state.get("fired_at")
        self._fired_at = None if fired is None else int(fired)
