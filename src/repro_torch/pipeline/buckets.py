"""Wave artifacts: which leaves exchange together, and when — the
counterpart of ``repro.pipeline.buckets``.

A ``Wave`` is an ordered group of model leaves whose sparse exchange is
launched together: as soon as the last of its gradients lands in
backprop (``pipeline="wave"``), or before the next step's forward pass
(``pipeline="async1"``).  A ``WaveSchedule`` is the full partition of
the model's leaves into waves plus the planner's predicted timeline, a
persistable artifact in the reference's JSON (same fields, same
``WAVE_SCHEDULE_VERSION``), so a schedule written by either package
binds in the other.

Leaf identity is carried twice: ``names`` ('/'-joined key paths, the
grammar of ``repro.autotune.schedule.leaf_entries``) and ``leaf_ids``
(indices into the flatten order of the live parameter tree, which
``exchange_bucket`` keys off).  ``bind`` re-derives ids from names.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch import tree
from repro_torch.core import bucketing

WAVE_SCHEDULE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Wave:
    """One exchange group.  ``leaf_ids`` are GLOBAL flatten-order indices
    (backprop order within the wave); ``t_ready`` is the predicted
    backward-clock time at which the wave's last gradient lands."""
    leaf_ids: tuple[int, ...]
    names: tuple[str, ...]
    nbytes: int = 0
    t_comm: float = 0.0
    t_ready: float = 0.0


@dataclasses.dataclass(frozen=True)
class WaveSchedule:
    waves: tuple[Wave, ...]
    pipeline: str = "wave"
    # planner outputs: t_step / t_comm / exposed_comm / overlap ...
    predicted: dict = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)
    version: int = WAVE_SCHEDULE_VERSION

    @property
    def n_waves(self) -> int:
        return len(self.waves)

    @property
    def n_leaves(self) -> int:
        return sum(len(w.leaf_ids) for w in self.waves)

    def validate_cover(self, n_leaves: int) -> None:
        """Every leaf in exactly one wave: the invariant that makes the
        waved exchange a pure regrouping of the monolithic one."""
        seen = [i for w in self.waves for i in w.leaf_ids]
        if sorted(seen) != list(range(n_leaves)):
            raise ValueError(
                f"wave schedule covers leaf ids {sorted(seen)}, expected "
                f"exactly 0..{n_leaves - 1} once each")

    def to_json(self) -> str:
        return json.dumps({
            "version": self.version,
            "pipeline": self.pipeline,
            "predicted": self.predicted,
            "meta": self.meta,
            "waves": [{"leaf_ids": list(w.leaf_ids),
                       "names": list(w.names),
                       "nbytes": int(w.nbytes),
                       "t_comm": float(w.t_comm),
                       "t_ready": float(w.t_ready)} for w in self.waves],
        }, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "WaveSchedule":
        obj = json.loads(text)
        if obj.get("version") != WAVE_SCHEDULE_VERSION:
            raise ValueError(
                f"wave schedule version {obj.get('version')!r} != "
                f"{WAVE_SCHEDULE_VERSION}")
        waves = tuple(Wave(leaf_ids=tuple(int(i) for i in w["leaf_ids"]),
                           names=tuple(w["names"]),
                           nbytes=int(w["nbytes"]),
                           t_comm=float(w["t_comm"]),
                           t_ready=float(w["t_ready"]))
                      for w in obj["waves"])
        return cls(waves=waves, pipeline=obj["pipeline"],
                   predicted=obj.get("predicted", {}),
                   meta=obj.get("meta", {}))


def leaf_names(params_like) -> list[str]:
    """Leaf path names in FLATTEN order (ids index into this list)."""
    return tree.leaf_paths(params_like)


def bind(ws: WaveSchedule, params_like) -> WaveSchedule:
    """Re-derive ``leaf_ids`` from ``names`` against a live parameter
    tree (schedules persist names; ids are per-process)."""
    names = leaf_names(params_like)
    index = {n: i for i, n in enumerate(names)}
    missing = [n for w in ws.waves for n in w.names if n not in index]
    if missing:
        raise ValueError(f"wave schedule names not in params: {missing[:4]}")
    waves = tuple(dataclasses.replace(
        w, leaf_ids=tuple(index[n] for n in w.names)) for w in ws.waves)
    out = dataclasses.replace(ws, waves=waves)
    out.validate_cover(len(names))
    return out


def waves_to_buckets(ws: WaveSchedule) -> list[bucketing.Bucket]:
    """View waves as ``bucketing.Bucket``s so ``bucket_stats`` applies."""
    return [bucketing.Bucket(tuple(w.leaf_ids), int(w.nbytes))
            for w in ws.waves]


def stats(ws: WaveSchedule) -> dict:
    return bucketing.bucket_stats(waves_to_buckets(ws))
