"""One process-wide metrics plane across train, replan, stream and serve
(a copy of ``repro.observe.metrics``, stdlib only).

A :class:`MetricsRegistry` holds counters, gauges and histograms keyed by
(name, label set); the four instrumented subsystems each own a name
prefix, and label *values* reuse the ``lags/...`` / ``serve/...`` string
grammar of :mod:`repro_torch.observe.names` where a sample refers to a traced
span (so a metric row and a trace event about the same work carry the
same string).

Subsystem prefixes (see :func:`subsystem`):

  * ``train_*``   — ``api.Session.run``: per-step wall time, loss,
    predicted exchange payload bytes under the live schedule;
  * ``replan_*``  — ``runtime.ReplanController``: per-trigger fire
    counts, swap decisions, trace-attributed step times;
  * ``publish_*`` / ``guard_*`` — ``repro_torch.stream`` (the *stream*
    subsystem): delta bytes vs
    full-checkpoint-equivalent bytes, packet kinds, held-out-NLL probe +
    trip count;
  * ``serve_*``   — ``stream.ServeSession``: per-request records
    (prefill latency, decode tokens/s, applied weight version), packet
    apply outcomes, jit-cache builds.

Two exporters, both deterministic (sorted metric names, sorted label
keys, shortest-repr floats) so CI can golden-file and byte-compare them:

  * :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
    format (``# HELP`` / ``# TYPE`` + one line per sample; histogram
    ``_bucket``/``_sum``/``_count`` expansion, label-value escaping);
  * :func:`save_snapshot` — a ``checkpoint.io``-style artifact pair
    ``<path>.jsonl`` (one JSON row per metric sample and per
    :class:`~repro_torch.observe.events.Event`) + ``<path>.json`` sidecar
    (schema version, row counts, covered subsystems, caller metadata),
    plus the ``<path>.prom`` text export next to them.

The module is import-leaf (stdlib only) like ``observe.names``, so every
instrumented package (``api``, ``runtime``, ``stream``) can depend on it
without import cycles.  :data:`REGISTRY` is the process-wide default;
benchmarks and tests that need isolation construct their own registry
and pass it down (every instrumented constructor takes ``metrics=``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Iterable, Mapping, Sequence

#: Wall-time histogram boundaries (seconds): µs-scale decode steps up to
#: tens-of-seconds compile-inclusive first steps.
DEFAULT_BUCKETS = (1e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

#: JSONL snapshot schema version (rows carry it via the sidecar).
SNAPSHOT_SCHEMA = 1

#: metric-name prefix -> subsystem (stream owns two prefixes).
_PREFIX_SUBSYSTEM = {"train": "train", "replan": "replan",
                     "publish": "stream", "guard": "stream",
                     "serve": "serve"}

SUBSYSTEMS = ("train", "replan", "stream", "serve")


def subsystem(metric_name: str) -> str | None:
    """Subsystem owning a metric name, from its ``<prefix>_`` (None for
    foreign names)."""
    return _PREFIX_SUBSYSTEM.get(metric_name.split("_", 1)[0])


def fmt_value(v: float) -> str:
    """Deterministic number rendering shared by both exporters:
    integral values print as integers, everything else as the shortest
    round-tripping repr; infinities use the Prometheus spelling."""
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


class _Metric:
    """Shared machinery: one value cell per label set."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str]):
        self.name = str(name)
        self.help = str(help)
        # sorted at declaration: export order must not depend on the
        # order a call site happened to list its labels in
        self.labelnames = tuple(sorted(labelnames))
        self._cells: dict[tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def _zero(self):
        return 0.0

    def _key(self, labels: Mapping[str, object]) -> tuple[str, ...]:
        if sorted(labels) != list(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, declared "
                f"{list(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def _cell(self, labels: Mapping[str, object]):
        key = self._key(labels)
        with self._lock:
            if key not in self._cells:
                self._cells[key] = self._zero()
            return key

    def items(self) -> list[tuple[tuple[str, ...], object]]:
        """(label values, cell) sorted by label values — the one
        iteration order both exporters use."""
        with self._lock:
            return sorted(self._cells.items())

    def labels_dict(self, key: tuple[str, ...]) -> dict[str, str]:
        return dict(zip(self.labelnames, key))


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up "
                             f"(inc({amount}))")
        key = self._cell(labels)
        with self._lock:
            self._cells[key] += float(amount)

    def value(self, **labels) -> float:
        return float(self._cells.get(self._key(labels), 0.0))

    def total(self) -> float:
        """Sum over every label set (e.g. ``publish_bytes_total`` across
        packet kinds)."""
        with self._lock:
            return float(sum(self._cells.values()))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._cell(labels)
        with self._lock:
            self._cells[key] = float(value)

    def value(self, **labels) -> float:
        return float(self._cells.get(self._key(labels), 0.0))


@dataclasses.dataclass
class _HistCell:
    counts: list[int]          # per-boundary, non-cumulative
    sum: float = 0.0
    count: int = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"{name}: histogram needs >= 1 bucket")
        self.buckets = bs

    def _zero(self):
        return _HistCell(counts=[0] * (len(self.buckets) + 1))

    def observe(self, value: float, **labels) -> None:
        key = self._cell(labels)
        v = float(value)
        with self._lock:
            cell = self._cells[key]
            i = len(self.buckets)
            for j, b in enumerate(self.buckets):
                if v <= b:
                    i = j
                    break
            cell.counts[i] += 1
            cell.sum += v
            cell.count += 1

    def cumulative(self, cell: _HistCell) -> list[tuple[str, int]]:
        """[(le, cumulative count)] including the +Inf bucket."""
        out, acc = [], 0
        for b, c in zip(self.buckets, cell.counts):
            acc += c
            out.append((fmt_value(b), acc))
        out.append(("+Inf", acc + cell.counts[-1]))
        return out


class MetricsRegistry:
    """Get-or-create metric store with deterministic exporters."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kw)
                self._metrics[name] = m
                return m
        if type(m) is not cls:
            raise ValueError(f"{name} already registered as {m.kind}, "
                             f"requested {cls.kind}")
        if m.labelnames != tuple(sorted(labelnames)):
            raise ValueError(f"{name}: label names {sorted(labelnames)} != "
                             f"registered {list(m.labelnames)}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def subsystems(self) -> list[str]:
        """Subsystems with at least one *sampled* metric."""
        out = set()
        for name in self._metrics:
            if self._metrics[name].items():
                sub = subsystem(name)
                if sub:
                    out.add(sub)
        return sorted(out)

    def reset(self) -> None:
        """Drop every metric (tests / bench sections needing isolation)."""
        with self._lock:
            self._metrics.clear()

    # -- exporters ----------------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition format, deterministically ordered
        (names sorted, label keys sorted at declaration, label values
        sorted per metric)."""
        lines: list[str] = []
        for name in self.names():
            m = self._metrics[name]
            items = m.items()
            if not items:
                continue
            lines.append(f"# HELP {name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, cell in items:
                base_labels = [
                    f'{k}="{_escape_label(v)}"'
                    for k, v in zip(m.labelnames, key)]
                if isinstance(m, Histogram):
                    for le, acc in m.cumulative(cell):
                        lab = ",".join(base_labels + [f'le="{le}"'])
                        lines.append(f"{name}_bucket{{{lab}}} {acc}")
                    suffix = ("{" + ",".join(base_labels) + "}"
                              if base_labels else "")
                    lines.append(f"{name}_sum{suffix} "
                                 f"{fmt_value(cell.sum)}")
                    lines.append(f"{name}_count{suffix} {cell.count}")
                else:
                    suffix = ("{" + ",".join(base_labels) + "}"
                              if base_labels else "")
                    lines.append(f"{name}{suffix} {fmt_value(cell)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot_rows(self) -> list[dict]:
        """One JSON-ready row per (metric, label set) sample, sorted."""
        rows: list[dict] = []
        for name in self.names():
            m = self._metrics[name]
            for key, cell in m.items():
                row = {"type": "metric", "name": name, "kind": m.kind,
                       "labels": m.labels_dict(key)}
                if isinstance(m, Histogram):
                    row["sum"] = cell.sum
                    row["count"] = cell.count
                    row["buckets"] = [[le, acc]
                                      for le, acc in m.cumulative(cell)]
                else:
                    row["value"] = float(cell)
                rows.append(row)
        return rows


#: The process-wide default plane every instrumented component falls
#: back to when not handed an explicit registry.
REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return REGISTRY


# ---------------------------------------------------------------------------
# snapshot artifact: <path>.jsonl + <path>.json sidecar + <path>.prom
# ---------------------------------------------------------------------------

def _dump_row(row: dict) -> str:
    return json.dumps(row, sort_keys=True, separators=(",", ":"))


def save_snapshot(path: str, registry: MetricsRegistry | None = None,
                  events=None, meta: dict | None = None) -> str:
    """Persist the plane as a ``checkpoint.io``-style artifact pair.

    ``<path>.jsonl`` holds one row per metric sample followed by one row
    per event (from ``events``, an ``observe.events.EventLog`` — the
    process default when None); ``<path>.json`` is the sidecar with the
    schema version, row counts, the covered subsystems and caller
    ``meta``; ``<path>.prom`` is the Prometheus text export.  Returns
    the ``.jsonl`` path.
    """
    from repro_torch.observe import events as OE
    reg = registry if registry is not None else REGISTRY
    log = events if events is not None else OE.EVENTS
    # no silent caps: a bounded ring that evicted events must say so,
    # both as a counter row and in the sidecar counts
    dropped = int(getattr(log, "dropped", 0))
    if dropped:
        c = reg.counter("observe/events/dropped_total",
                        "Events evicted by the bounded EventLog ring.")
        behind = dropped - c.value()
        if behind > 0:
            c.inc(behind)
    rows = reg.snapshot_rows()
    ev_rows = [e.to_row() for e in log.events()]
    subsystems = set(reg.subsystems())
    for e in log.events():
        sub = OE.subsystem_of_kind(e.kind)
        if sub:
            subsystems.add(sub)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    base = path.removesuffix(".jsonl")
    with open(base + ".jsonl", "w") as f:
        for row in rows + ev_rows:
            f.write(_dump_row(row) + "\n")
    with open(base + ".prom", "w") as f:
        f.write(reg.to_prometheus())
    sidecar = {"schema": SNAPSHOT_SCHEMA,
               "counts": {"metrics": len(rows), "events": len(ev_rows),
                          "events_dropped": dropped},
               "subsystems": sorted(subsystems),
               "metadata": meta or {}}
    with open(base + ".json", "w") as f:
        json.dump(sidecar, f, sort_keys=True, indent=1)
    return base + ".jsonl"


def load_snapshot(path: str) -> dict:
    """``{"meta", "metrics", "events"}`` from a :func:`save_snapshot`
    artifact (``path`` with or without the ``.jsonl`` suffix)."""
    base = path.removesuffix(".jsonl")
    with open(base + ".json") as f:
        meta = json.load(f)
    metrics, events = [], []
    with open(base + ".jsonl") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            (metrics if row.get("type") == "metric" else events).append(row)
    return {"meta": meta, "metrics": metrics, "events": events}


def metric_total(snap: dict, name: str) -> float:
    """Sum of a counter/gauge over every label set in a loaded snapshot."""
    return float(sum(r.get("value", 0.0) for r in snap["metrics"]
                     if r["name"] == name))
