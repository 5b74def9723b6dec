"""Structured, versioned event bus for operational state changes (a
copy of ``repro.observe.events``, stdlib only).

Where :mod:`repro_torch.observe.metrics` answers "how much / how fast", the
:class:`EventLog` answers "what happened, in what order": replan
decisions and trigger firings (``runtime.ReplanController``), publishes
(``stream.StreamPublisher``), guard trips/pins/resumes
(``stream.RolloutGuard``), packet applies, resyncs and per-request
records (``stream.ServeSession``).  Every producer appends
:class:`Event`\\ s carrying an explicit ``schema`` version so a consumer
reading a persisted snapshot can tell which field vocabulary it was
written under.

Events deliberately carry **no wall-clock timestamp**: ordering is the
monotone ``seq``, position in a run is ``step`` (train step or packet
version), and the deterministic CI paths (fake-trace backend) stay
byte-reproducible.  ``name`` holds a ``repro_torch.observe.names`` grammar
string when the event corresponds to a traced span (e.g. a serve request
under ``serve/<kind>/<label>?version=``).

The log is a bounded ring (oldest events drop first) and is exported as
rows inside the same JSONL snapshot artifact the metrics registry writes
(:func:`repro_torch.observe.metrics.save_snapshot`).  Import-leaf, stdlib
only.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import threading
from typing import Iterator

#: Event-row schema version.
EVENT_SCHEMA = 1

#: Known event kinds per subsystem (producers may add more; consumers
#: must tolerate unknown kinds within a schema version).
EVENT_KINDS = {
    "train": ("health_alarm",),
    "replan": ("trigger", "replan"),
    "stream": ("publish", "guard_trip", "guard_pin", "guard_resume"),
    "serve": ("apply", "resync", "request"),
}


def subsystem_of_kind(kind: str) -> str | None:
    for sub, kinds in EVENT_KINDS.items():
        if kind in kinds:
            return sub
    return None


@dataclasses.dataclass(frozen=True)
class Event:
    """One state change: ``seq`` orders, ``step`` locates (train step or
    packet version), ``data`` carries the kind-specific payload."""
    seq: int
    kind: str
    step: int
    name: str = ""
    data: dict = dataclasses.field(default_factory=dict)
    schema: int = EVENT_SCHEMA

    def to_row(self) -> dict:
        return {"type": "event", "schema": self.schema, "seq": self.seq,
                "kind": self.kind, "step": self.step, "name": self.name,
                "data": self.data}

    @staticmethod
    def from_row(row: dict) -> "Event":
        return Event(seq=int(row["seq"]), kind=str(row["kind"]),
                     step=int(row["step"]), name=str(row.get("name", "")),
                     data=dict(row.get("data", {})),
                     schema=int(row.get("schema", EVENT_SCHEMA)))


class EventLog:
    """Bounded, thread-safe, append-only event ring."""

    def __init__(self, capacity: int = 8192):
        self._ring: collections.deque[Event] = \
            collections.deque(maxlen=int(capacity))
        self._seq = 0
        self._dropped = 0
        self._lock = threading.Lock()

    def emit(self, kind: str, *, step: int = 0, name: str = "",
             **data) -> Event:
        """Append one event; ``data`` values must be JSON-serializable
        (enforced here, not at snapshot time, so a bad producer fails at
        its own call site).  A full ring drops its oldest event — counted
        in :attr:`dropped`, never silent (the snapshot sidecar and the
        ``observe/events/dropped_total`` counter surface it)."""
        json.dumps(data)
        with self._lock:
            if (self._ring.maxlen is not None
                    and len(self._ring) == self._ring.maxlen):
                self._dropped += 1
            ev = Event(seq=self._seq, kind=str(kind), step=int(step),
                       name=str(name), data=data)
            self._seq += 1
            self._ring.append(ev)
        return ev

    @property
    def dropped(self) -> int:
        """Events evicted by the bounded ring since the last clear."""
        with self._lock:
            return self._dropped

    def events(self, kind: str | None = None) -> list[Event]:
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        return evs

    def last(self, kind: str | None = None) -> Event | None:
        evs = self.events(kind)
        return evs[-1] if evs else None

    def __len__(self) -> int:
        return len(self._ring)

    def __iter__(self) -> Iterator[Event]:
        return iter(self.events())

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._dropped = 0

    def to_jsonl(self) -> str:
        return "".join(json.dumps(e.to_row(), sort_keys=True,
                                  separators=(",", ":")) + "\n"
                       for e in self.events())


#: Process-wide default bus (mirrors ``metrics.REGISTRY``).
EVENTS = EventLog()


def default_events() -> EventLog:
    return EVENTS
