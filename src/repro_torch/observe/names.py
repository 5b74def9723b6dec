"""Annotation-name vocabulary shared by every trace producer/consumer.

A trace event is attributed purely from its *name*, so the exchange code
(`core.lags`' ``record_function`` scopes), the deterministic fake backend
(:class:`~repro_torch.observe.trace.FakeTraceBackend`) and real
``torch.profiler`` captures all speak one string grammar (a copy of
``repro.observe.names``, stdlib only):

  * ``lags/step``                         — one whole train step
  * ``lags/fwd``                          — the forward pass
  * ``lags/bwd/<leaf path>``              — one leaf's backward compute
  * ``lags/comm/<tier>/<kind>/<label>?nbytes=<B>&p=<P>``
                                          — one collective (per bucket /
                                            per leaf / per wave); ``tier``
                                            is ``flat`` | ``inner`` |
                                            ``outer``, ``kind`` is
                                            ``allgather`` | ``allreduce``
  * ``lags/overlap/<label>``              — overlap-attribution span
                                            labels: the ``span`` label
                                            value of the
                                            ``train_overlap_comm_seconds``
                                            gauge family
                                            (``repro_torch.pipeline.overlap``)
  * ``lags/health/<kind>/<label>``        — convergence-health quantity
                                            (``repro_torch.observe.health``);
                                            ``kind`` is one of
                                            :data:`HEALTH_KINDS` and
                                            ``label`` is a leaf path or a
                                            ``<tier>/<leaf path>`` pair
  * ``serve/<kind>/<label>?version=<V>``  — serving-path work
                                            (``repro.stream``); ``kind``
                                            is one of :data:`SERVE_KINDS`

Leaf paths may themselves contain ``/`` (``layers/0/attn/wq``): the
``bwd`` payload is everything after the prefix, and the ``comm`` label
is everything after the third slash-separated field.  ``nbytes``/``p``
ride in the name because a device annotation has no other side channel
for metadata — :func:`parse` recovers them for
``repro_torch.observe.attribution``.

This module is import-leaf (stdlib only) so ``repro_torch.core`` can annotate
collectives without pulling the rest of the observe package — or any
cycle — into its import graph.
"""
from __future__ import annotations

STEP = "lags/step"
FWD = "lags/fwd"
BWD_PREFIX = "lags/bwd/"
COMM_PREFIX = "lags/comm/"
OVERLAP_PREFIX = "lags/overlap/"
HEALTH_PREFIX = "lags/health/"
SERVE_PREFIX = "serve/"

#: Tier vocabulary: flat data-parallel wire, intra-pod ICI, cross-pod DCN.
TIERS = ("flat", "inner", "outer")

#: Serve-side work kinds (``repro.stream`` subscriber): prompt prefill,
#: one-token decode, a delta-packet apply, a full-checkpoint resync, and
#: a rollout-guard quality eval.
SERVE_KINDS = ("prefill", "decode", "apply", "resync", "eval")

#: Convergence-health kinds (``repro_torch.observe.health``): the online
#: per-leaf Assumption-1 ratio (Eq. 20), EF-residual energy retention,
#: and the async1 one-step staleness gap.
HEALTH_KINDS = ("delta", "ef_energy", "staleness")


def bwd_name(leaf: str) -> str:
    return BWD_PREFIX + leaf


def overlap_name(label: str) -> str:
    """``lags/overlap/<label>`` — metric-label spelling for one
    collective's overlap attribution (``label`` is the same string the
    ``comm`` event carried)."""
    return OVERLAP_PREFIX + label


def health_name(kind: str, label: str = "") -> str:
    """``lags/health/<kind>/<label>`` — one convergence-health quantity.
    ``label`` is a leaf path (``layers/0/attn/wq``) or, for tiered
    quantities, ``<tier>/<leaf path>``."""
    return f"{HEALTH_PREFIX}{kind}/{label}"


def serve_name(kind: str, label: str = "", *,
               version: int | None = None) -> str:
    """``serve/<kind>/<label>[?version=<v>]`` — the serving-path analogue
    of the ``lags/`` training grammar.  ``version`` rides in the name for
    the same reason ``nbytes`` does on ``comm``: a device annotation has
    no other metadata side channel."""
    name = f"{SERVE_PREFIX}{kind}/{label}"
    if version is not None:
        name += f"?version={int(version)}"
    return name


def comm_name(tier: str, kind: str, label: str, *, nbytes: float,
              p: int) -> str:
    return (f"{COMM_PREFIX}{tier}/{kind}/{label}"
            f"?nbytes={float(nbytes):.6g}&p={int(p)}")


def parse(name: str) -> dict | None:
    """Structured view of an annotation name, or None for foreign names.

    Returns ``{"type": "step" | "fwd"}``, ``{"type": "bwd", "leaf": ...}``,
    ``{"type": "comm", "tier", "kind", "label", "nbytes", "p"}``,
    ``{"type": "overlap", "label": ...}`` or
    ``{"type": "health", "kind", "label"}``.
    Malformed ``comm`` metadata parses as ``nbytes=0.0 / p=1`` rather
    than raising — a real profiler run may mangle suffixes, and a sample
    with no payload is simply dropped downstream.
    """
    if name == STEP:
        return {"type": "step"}
    if name == FWD:
        return {"type": "fwd"}
    if name.startswith(BWD_PREFIX):
        return {"type": "bwd", "leaf": name[len(BWD_PREFIX):]}
    if name.startswith(COMM_PREFIX):
        rest = name[len(COMM_PREFIX):]
        parts = rest.split("/", 2)
        if len(parts) != 3:
            return None
        tier, kind, tail = parts
        label, _, query = tail.partition("?")
        nbytes, p = 0.0, 1
        for field in query.split("&"):
            key, _, val = field.partition("=")
            try:
                if key == "nbytes":
                    nbytes = float(val)
                elif key == "p":
                    p = int(val)
            except ValueError:
                pass
        return {"type": "comm", "tier": tier, "kind": kind, "label": label,
                "nbytes": nbytes, "p": p}
    if name.startswith(OVERLAP_PREFIX):
        return {"type": "overlap", "label": name[len(OVERLAP_PREFIX):]}
    if name.startswith(HEALTH_PREFIX):
        rest = name[len(HEALTH_PREFIX):]
        kind, _, label = rest.partition("/")
        if not kind:
            return None
        return {"type": "health", "kind": kind, "label": label}
    if name.startswith(SERVE_PREFIX):
        rest = name[len(SERVE_PREFIX):]
        parts = rest.split("/", 1)
        if len(parts) != 2:
            return None
        kind, tail = parts
        label, _, query = tail.partition("?")
        version = None
        for field in query.split("&"):
            key, _, val = field.partition("=")
            if key == "version":
                try:
                    version = int(val)
                except ValueError:
                    pass
        return {"type": "serve", "kind": kind, "label": label,
                "version": version}
    return None
