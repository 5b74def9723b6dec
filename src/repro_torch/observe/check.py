"""Snapshot validation: the CI gate over the exported metrics plane (a
copy of ``repro.observe.check``).

``python -m repro_torch.observe.check <snapshot> --require train replan`` loads
a :func:`repro_torch.observe.metrics.save_snapshot` artifact and fails (exit
code = number of problems) unless it parses, carries the expected schema,
covers the required subsystems, and satisfies the cross-metric
invariants:

  * ``publish_bytes_total <= publish_bytes_full_equiv_total`` — the
    delta stream must never cost more than shipping full checkpoints at
    the same cadence (``--max-publish-ratio`` tightens the bound, e.g.
    ``0.25`` re-asserts bench_stream's contract on a live run);
  * when ``serve`` is required, at least one ``request`` event must be
    present (per-request records are the serve subsystem's payload, not
    just its counters) and each must carry the ``RequestRecord`` core
    fields (prefill latency, decode tokens/s, applied weight version).

  * ``--min-overlap R`` — the run must have reported comm-overlap
    gauges (:data:`OVERLAP_METRICS`, from ``repro_torch.pipeline`` /
    ``api.Session.run`` / the replan controller), and every reported
    fraction must be ``>= R`` — the gate a wave-pipelined runtime smoke
    puts on "the overlap actually happened".

  * ``--require-health`` — the run must have exported the convergence-
    health plane (``repro_torch.observe.health``): per-leaf online
    Assumption-1 delta gauges (``train_health_delta``) and, when the
    snapshot covers the stream subsystem, the stream codec's residual
    energy-retention gauges (``publish_health_ef_energy``).

  * ``--max-delta R`` — every reported online delta (per-leaf and max)
    must be ``<= R``; ``--max-delta 1.0`` is the paper's Assumption-1
    bound, looser values gate CI smokes against divergence.

Usable as a library too: :func:`validate` returns the list of problems.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.observe import metrics as OM

#: RequestRecord fields every ``request`` event row must carry.
REQUEST_FIELDS = ("prefill_s", "decode_tok_s", "version")

#: Gauge families carrying a comm-overlap fraction (``--min-overlap``):
#: the session's per-mode predicted/achieved pair and the controller's
#: fresh-fit wave-plan prediction.
OVERLAP_METRICS = ("train_overlap_frac", "replan_overlap_frac")

#: Gauge families carrying the online Assumption-1 delta
#: (``--max-delta`` bounds every sample of these).
DELTA_METRICS = ("train_health_delta", "train_health_delta_max")


def validate(snap: dict, require: tuple[str, ...] = (),
             max_publish_ratio: float | None = None,
             min_overlap: float | None = None,
             require_health: bool = False,
             max_delta: float | None = None) -> list[str]:
    """Problems with a loaded snapshot (empty list = valid)."""
    problems: list[str] = []
    meta = snap.get("meta", {})
    if meta.get("schema") != OM.SNAPSHOT_SCHEMA:
        problems.append(f"schema {meta.get('schema')!r} != "
                        f"{OM.SNAPSHOT_SCHEMA}")
    counts = meta.get("counts", {})
    if counts.get("metrics") != len(snap.get("metrics", ())):
        problems.append(f"sidecar counts {counts.get('metrics')} metric "
                        f"rows, jsonl has {len(snap.get('metrics', ()))}")
    if counts.get("events") != len(snap.get("events", ())):
        problems.append(f"sidecar counts {counts.get('events')} event "
                        f"rows, jsonl has {len(snap.get('events', ()))}")
    covered = set(meta.get("subsystems", ()))
    # re-derive coverage from the rows: the sidecar must not over-claim
    derived = {s for s in (OM.subsystem(r["name"])
                           for r in snap.get("metrics", ())) if s}
    from repro_torch.observe import events as OE
    derived |= {s for s in (OE.subsystem_of_kind(r.get("kind", ""))
                            for r in snap.get("events", ())) if s}
    if covered - derived:
        problems.append(f"sidecar claims uncovered subsystems: "
                        f"{sorted(covered - derived)}")
    for sub in require:
        if sub not in derived:
            problems.append(f"required subsystem {sub!r} missing "
                            f"(covered: {sorted(derived)})")
    bad_rows = [r for r in snap.get("metrics", ())
                if r.get("kind") == "histogram"
                and r.get("count", 0) != (r.get("buckets") or
                                          [["+Inf", -1]])[-1][1]]
    if bad_rows:
        problems.append(f"histogram count != +Inf bucket in "
                        f"{[r['name'] for r in bad_rows]}")
    # stream invariant: deltas never cost more than full checkpoints
    published = OM.metric_total(snap, "publish_bytes_total")
    full_equiv = OM.metric_total(snap, "publish_bytes_full_equiv_total")
    if full_equiv > 0:
        bound = full_equiv * (max_publish_ratio
                              if max_publish_ratio is not None else 1.0)
        if published > bound:
            problems.append(
                f"publish_bytes_total {published:.0f} > "
                f"{bound:.0f} (= {max_publish_ratio or 1.0} x "
                f"full-equivalent {full_equiv:.0f})")
    elif "stream" in require:
        problems.append("stream required but no "
                        "publish_bytes_full_equiv_total samples")
    if "serve" in require:
        requests = [r for r in snap.get("events", ())
                    if r.get("kind") == "request"]
        if not requests:
            problems.append("serve required but no per-request records "
                            "(kind='request' events)")
        for r in requests:
            missing = [f for f in REQUEST_FIELDS
                       if f not in r.get("data", {})]
            if missing:
                problems.append(f"request event seq={r.get('seq')} "
                                f"missing fields {missing}")
    if min_overlap is not None:
        rows = [r for r in snap.get("metrics", ())
                if r["name"] in OVERLAP_METRICS]
        if not rows:
            problems.append(
                f"--min-overlap given but no overlap gauges "
                f"({'/'.join(OVERLAP_METRICS)}) in the snapshot — was "
                f"the run pipelined?")
        for r in rows:
            if r.get("value", 0.0) < min_overlap:
                problems.append(
                    f"{r['name']}{r.get('labels', {})} = "
                    f"{r.get('value', 0.0):.3f} < --min-overlap "
                    f"{min_overlap}")
    delta_rows = [r for r in snap.get("metrics", ())
                  if r["name"] in DELTA_METRICS]
    if require_health:
        if not delta_rows:
            problems.append(
                "--require-health given but no online delta gauges "
                f"({'/'.join(DELTA_METRICS)}) in the snapshot — was the "
                "run launched with health_every > 0?")
        if "stream" in require or "stream" in covered:
            stream_rows = [r for r in snap.get("metrics", ())
                           if r["name"] == "publish_health_ef_energy"]
            if not stream_rows:
                problems.append(
                    "--require-health: snapshot covers the stream "
                    "subsystem but carries no publish_health_ef_energy "
                    "gauges (stream-residual health)")
    if max_delta is not None:
        if not delta_rows:
            problems.append(
                f"--max-delta given but no online delta gauges "
                f"({'/'.join(DELTA_METRICS)}) in the snapshot")
        for r in delta_rows:
            if r.get("value", 0.0) > max_delta:
                problems.append(
                    f"{r['name']}{r.get('labels', {})} = "
                    f"{r.get('value', 0.0):.3g} > --max-delta "
                    f"{max_delta}")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate an exported repro_torch.observe metrics "
                    "snapshot")
    ap.add_argument("snapshot", help="path from metrics.save_snapshot "
                                     "(with or without .jsonl)")
    ap.add_argument("--require", nargs="*", default=[],
                    choices=list(OM.SUBSYSTEMS),
                    help="subsystems the snapshot must cover")
    ap.add_argument("--max-publish-ratio", type=float, default=None,
                    help="tighten publish_bytes_total <= RATIO x "
                         "full-checkpoint-equivalent bytes (default 1.0)")
    ap.add_argument("--min-overlap", type=float, default=None,
                    help="require overlap gauges (train/replan_overlap_"
                         "frac) to be present and >= this fraction")
    ap.add_argument("--require-health", action="store_true",
                    help="require the convergence-health plane: online "
                         "delta gauges (+ stream-residual energy gauges "
                         "when the snapshot covers stream)")
    ap.add_argument("--max-delta", type=float, default=None,
                    help="bound every online Assumption-1 delta sample "
                         "(train_health_delta[_max]); 1.0 = the paper's "
                         "bound")
    args = ap.parse_args(argv)
    try:
        snap = OM.load_snapshot(args.snapshot)
    except (OSError, ValueError) as e:
        print(f"metrics-check: cannot load {args.snapshot}: {e}")
        return 1
    problems = validate(snap, require=tuple(args.require),
                        max_publish_ratio=args.max_publish_ratio,
                        min_overlap=args.min_overlap,
                        require_health=args.require_health,
                        max_delta=args.max_delta)
    for p in problems:
        print(f"metrics-check: FAIL {p}")
    if not problems:
        meta = snap["meta"]
        print(f"metrics-check: OK {args.snapshot} — "
              f"{meta['counts']['metrics']} metric rows, "
              f"{meta['counts']['events']} events, "
              f"subsystems={meta['subsystems']}")
    return len(problems)


if __name__ == "__main__":
    sys.exit(main())
