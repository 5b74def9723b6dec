"""Persistable per-leaf sparsification schedules: the port of
``repro.autotune.schedule``, the same JSON both ways.

A ``Schedule`` is the artifact the autotune pipeline emits: one
``LeafPlan`` (compression ratio c^(l) and budget k^(l)) per learnable
leaf, keyed by the leaf's pytree path, plus the provenance needed to
decide whether a cached schedule still applies — (arch, input shape,
worker count, train mode, calibrated hardware).  Schedules round-trip
through JSON so a profile→fit→plan run is paid once per (arch, mesh,
hardware) and reused across training jobs; ingestion happens through
``core.lags.ks_from_ratios_tree`` via :meth:`Schedule.ratios_tree`.
Leaf names are ``repro_torch.tree.leaf_paths`` ('/'-joined key paths),
the names the reference writes, so a schedule written by either package
loads in the other.

Version history:

  * v1 — flat per-leaf plans only, no ``train_mode`` provenance.
  * v2 — adds ``train_mode`` to ``Schedule`` and introduces the
    two-tier ``HierSchedule`` (intra-pod / cross-pod plans for the
    ``lags_hier`` train mode).  v1 documents load with
    ``train_mode="lags_dp"`` (the only mode v1 plans ever fed).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Sequence

from repro_torch import tree

SCHEDULE_VERSION = 2

#: Train modes that split the exchange into intra-pod / cross-pod tiers
#: and may therefore consume a two-tier ``HierSchedule``.  ``lags_hier``
#: consumes the outer tier only (dense ICI reduction); ``lags_hier2``
#: consumes both tiers (sparse intra-pod exchange).
HIER_MODES = ("lags_hier", "lags_hier2")


def leaf_entries(params) -> list[tuple[str, Any]]:
    """[(path_name, leaf)] in flatten order ('decoder/blocks/...')."""
    return list(zip(tree.leaf_paths(params), tree.leaves(params)))


def _leaf_size(leaf) -> int:
    return int(math.prod(leaf.shape))


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Planned sparsification for one leaf: keep k of d at ratio c=d/k."""
    name: str
    d: int
    ratio: float
    k: int
    t_budget: float = 0.0   # compute budget the ratio was solved against (s)

    def __post_init__(self):
        if self.d <= 0 or self.k <= 0 or self.ratio < 1.0:
            raise ValueError(f"invalid LeafPlan {self}")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Per-leaf ratios for one (arch, shape, n_workers, mode, hw) tuple."""
    arch: str
    shape: str
    n_workers: int
    hardware: dict            # name/alpha/beta/flops/hbm_bw of the fit
    leaves: tuple[LeafPlan, ...]
    train_mode: str = "lags_dp"
    tier: str = ""            # ""=flat; "inner"/"outer" inside a HierSchedule
    version: int = SCHEDULE_VERSION

    # -- lookup ------------------------------------------------------------
    @property
    def by_name(self) -> dict[str, LeafPlan]:
        return {lp.name: lp for lp in self.leaves}

    def hardware_drift(self, alpha: float, beta: float) -> float:
        """How far a live (α, β) fit has drifted from the fit this
        schedule was solved against (``costfit.rel_drift``) — the
        fingerprint a re-planner checks to decide whether a cached
        schedule is stale."""
        from repro_torch.autotune import costfit
        return costfit.rel_drift(self.hardware, alpha, beta)

    def validate(self, params_like) -> None:
        """Raise ValueError unless the schedule covers exactly the leaves of
        ``params_like`` (same path names, same parameter counts)."""
        self.validate_sizes({name: _leaf_size(leaf)
                             for name, leaf in leaf_entries(params_like)})

    def validate_sizes(self, want: dict[str, int]) -> None:
        """``validate`` against a plain {leaf name: param count} mapping."""
        have = {lp.name: lp.d for lp in self.leaves}
        missing = sorted(set(want) - set(have))
        extra = sorted(set(have) - set(want))
        if missing or extra:
            raise ValueError(
                f"schedule for arch={self.arch!r} does not match the model's "
                f"leaf structure: missing={missing[:4]} extra={extra[:4]} "
                f"({len(missing)} missing / {len(extra)} extra leaves)")
        bad = [n for n in want if want[n] != have[n]]
        if bad:
            n = bad[0]
            raise ValueError(
                f"schedule leaf {n!r} has d={have[n]} but the model leaf has "
                f"{want[n]} params ({len(bad)} mismatched leaves)")

    def ratios_tree(self, params_like) -> Any:
        """Pytree (matching ``params_like``) of per-leaf ratios — the input
        to ``core.lags.ks_from_ratios_tree``.  Validates first."""
        self.validate(params_like)
        ratios = self.by_name
        _, treedef = tree.flatten(params_like)
        return tree.unflatten(treedef, [ratios[name].ratio for name in
                                        tree.leaf_paths(params_like)])

    def ks_tree(self, params_like) -> Any:
        """Per-leaf k^(l) pytree for ``params_like`` — the single ingestion
        path: validates, then feeds the planned ratios through
        ``core.lags.ks_from_ratios_tree`` (the same rounding the planner
        used, so the result equals the persisted ``LeafPlan.k``)."""
        from repro_torch.core import lags
        return lags.ks_from_ratios_tree(params_like,
                                        self.ratios_tree(params_like))

    # -- JSON round-trip ---------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "Schedule":
        obj = json.loads(text)
        if obj.get("kind") == "hier":
            raise ValueError("this is a hierarchical schedule — load it "
                             "with HierSchedule.from_json / load_any")
        return Schedule._from_obj(obj)

    @staticmethod
    def _from_obj(obj: dict) -> "Schedule":
        version = int(obj.get("version", 0))
        if version == 1:
            # v1 migration: flat plans, no train_mode provenance — every
            # v1 schedule was planned for (and consumed by) lags_dp
            obj = dict(obj, train_mode="lags_dp")
        elif version != SCHEDULE_VERSION:
            raise ValueError(f"schedule version {version} != "
                             f"{SCHEDULE_VERSION} (re-run the autotuner)")
        leaves = tuple(LeafPlan(**lp) for lp in obj["leaves"])
        return Schedule(arch=obj["arch"], shape=obj["shape"],
                        n_workers=int(obj["n_workers"]),
                        hardware=dict(obj["hardware"]), leaves=leaves,
                        train_mode=str(obj.get("train_mode", "lags_dp")),
                        tier=str(obj.get("tier", "")),
                        version=SCHEDULE_VERSION)

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @staticmethod
    def load(path: str) -> "Schedule":
        with open(path) as f:
            return Schedule.from_json(f.read())


@dataclasses.dataclass(frozen=True)
class HierSchedule:
    """Two-tier schedule for the hierarchical train modes (HIER_MODES).

    ``inner`` plans the intra-pod tier (fast ICI — dense, ratio 1,
    whenever the wire hides behind backward compute; sparse when ICI is
    contended) and ``outer`` plans the cross-pod tier (slow DCN — the
    sparse LAGS exchange).  Each tier is a full flat :class:`Schedule`
    solved against that tier's own fitted α/β ``hardware`` and worker
    count.  Consumption depends on the mode: ``lags_hier`` ingests the
    *outer* tier only (its intra-pod reduction is GSPMD's dense
    all-reduce), while ``lags_hier2`` executes BOTH tiers — its sparse
    intra-pod exchange takes ``inner``'s k's and the cross-pod exchange
    takes ``outer``'s (``repro_torch.api.registry.resolve_schedule_ks``).
    The default :meth:`ks_tree` forwards to ``outer`` — the same
    ``core.lags.ks_from_ratios_tree`` path as flat schedules.
    """
    arch: str
    shape: str
    inner: Schedule
    outer: Schedule
    version: int = SCHEDULE_VERSION

    def __post_init__(self):
        have = {lp.name: lp.d for lp in self.inner.leaves}
        want = {lp.name: lp.d for lp in self.outer.leaves}
        if have != want:
            bad = sorted(set(have.items()) ^ set(want.items()))
            raise ValueError(
                f"HierSchedule tiers cover different leaves: {bad[:4]}")

    @property
    def n_tiers(self) -> int:
        return 2

    @property
    def tiers(self) -> dict[str, Schedule]:
        return {"inner": self.inner, "outer": self.outer}

    # -- ingestion (forwarded to the sparse cross-pod tier) ----------------
    def validate(self, params_like) -> None:
        self.inner.validate(params_like)
        self.outer.validate(params_like)

    def hardware_drift(self, alpha: float, beta: float,
                       tier: str = "outer") -> float:
        """Fingerprint drift of one tier's wire (default: the sparse
        cross-pod tier — the one a degraded DCN invalidates)."""
        return self.tiers[tier].hardware_drift(alpha, beta)

    def ratios_tree(self, params_like) -> Any:
        return self.outer.ratios_tree(params_like)

    def ks_tree(self, params_like) -> Any:
        return self.outer.ks_tree(params_like)

    # -- JSON round-trip ---------------------------------------------------
    def to_json(self) -> str:
        obj = {"kind": "hier", "version": self.version, "arch": self.arch,
               "shape": self.shape,
               "tiers": {"inner": dataclasses.asdict(self.inner),
                         "outer": dataclasses.asdict(self.outer)}}
        return json.dumps(obj, indent=1, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "HierSchedule":
        obj = json.loads(text)
        if obj.get("kind") != "hier":
            raise ValueError("not a hierarchical schedule — load it with "
                             "Schedule.from_json / load_any")
        version = int(obj.get("version", 0))
        if version != SCHEDULE_VERSION:
            raise ValueError(f"schedule version {version} != "
                             f"{SCHEDULE_VERSION} (re-run the autotuner)")
        return HierSchedule(
            arch=obj["arch"], shape=obj["shape"],
            inner=Schedule._from_obj(obj["tiers"]["inner"]),
            outer=Schedule._from_obj(obj["tiers"]["outer"]),
            version=version)

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @staticmethod
    def load(path: str) -> "HierSchedule":
        with open(path) as f:
            return HierSchedule.from_json(f.read())


def schedule_from_json(text: str) -> "Schedule | HierSchedule":
    """Parse either schedule kind (flat v1/v2 or hierarchical)."""
    obj = json.loads(text)
    if obj.get("kind") == "hier":
        return HierSchedule.from_json(text)
    return Schedule._from_obj(obj)


def load_any(path: str) -> "Schedule | HierSchedule":
    with open(path) as f:
        return schedule_from_json(f.read())


def validate_for(sched, mode: str, *, n_workers: int | None = None,
                 params_like=None) -> None:
    """Schedule-ingestion validation, shared by every consumer.

    Hoisted out of ``launch.train.build_train_step`` so it, ``SimTrainer``,
    and the runtime controller all enforce the SAME contract.  Only genuinely unconsumable combinations reject:

      * a two-tier ``HierSchedule`` only feeds the hierarchical modes
        (``HIER_MODES``): ``lags_hier`` ingests its outer tier,
        ``lags_hier2`` executes both tiers;
      * a flat schedule planned for one family of wires must not silently
        feed the other (per-leaf k's priced for a flat data-parallel
        exchange mis-price both tiers of a hierarchical one, and vice
        versa);
      * a lone intra-pod (inner) tier — near-dense by construction — may
        ONLY feed ``lags_hier2``, the one mode that actually runs a
        sparse intra-pod exchange (it budgets that tier; the outer tier
        falls back to the configured ratio).  Every other mode would pipe
        those near-dense k's into its cross-pod/flat sparse exchange, so
        the combination rejects;
      * a worker-count mismatch WARNS rather than fails: Eq. 18 ratios
        solved for a different P still converge (Lemma 1), and what-if
        consumption of a production plan on a smaller mesh is a
        supported flow.

    ``mode`` is the canonical train-mode vocabulary; ``n_workers=None``
    skips the worker-count check; ``params_like`` additionally checks the
    leaf structure (``Schedule.validate``).
    """
    if sched is None:
        return
    n_tiers = int(getattr(sched, "n_tiers", 1))
    if n_tiers > 1 and mode not in HIER_MODES:
        raise ValueError(
            f"hierarchical schedule (n_tiers={n_tiers}) requires a "
            f"hierarchical train mode (one of {list(HIER_MODES)}), "
            f"got {mode!r}")
    flat_mode = getattr(sched, "train_mode", None)
    if (n_tiers == 1 and flat_mode is not None
            and (flat_mode in HIER_MODES) != (mode in HIER_MODES)):
        raise ValueError(
            f"schedule was planned for train_mode={flat_mode!r} but "
            f"this step runs {mode!r} (re-plan, or load the matching "
            f"cache entry)")
    if getattr(sched, "tier", "") == "inner" and mode != "lags_hier2":
        raise ValueError(
            f"this is the intra-pod (inner) tier of a HierSchedule — "
            f"its near-dense k's must not feed the sparse cross-pod "
            f"exchange of {mode!r}; pass the full HierSchedule (or its "
            f"outer tier), or consume the inner tier with "
            f"train mode 'lags_hier2', whose intra-pod exchange is sparse")
    # duck-typed schedules ("anything with a ks_tree method") may carry no
    # worker-count provenance at all — skip the check, don't crash
    if n_tiers > 1 and mode == "lags_hier2":
        # both tiers execute: the mesh worker count is the tier product
        p_in = getattr(sched.inner, "n_workers", None)
        p_out = getattr(sched.outer, "n_workers", None)
        planned = (int(p_in) * int(p_out)
                   if p_in is not None and p_out is not None else None)
    elif getattr(sched, "tier", "") == "inner":
        # a lone inner tier budgets the intra-pod exchange only; its
        # n_workers is the PER-POD inner count, which the total mesh
        # worker count cannot be compared against — skip the check
        planned = None
    else:
        planned = getattr(getattr(sched, "outer", sched), "n_workers", None)
    if n_workers is not None and planned is not None:
        planned_p = int(planned)
        if planned_p != int(n_workers):
            import warnings
            warnings.warn(
                f"schedule was planned for {planned_p} workers but this "
                f"mesh runs {int(n_workers)} (mode {mode!r}) — planned "
                f"ratios will not match the wire", stacklevel=3)
    if params_like is not None:
        sched.validate(params_like)


def cache_path(root: str, arch: str, shape: str, n_workers: int,
               hw_name: str, train_mode: str = "lags_dp",
               tiers: int = 1) -> str:
    """Canonical on-disk location for a cached schedule.

    ``train_mode`` and ``tiers`` are part of the key: ``lags_dp`` and
    ``lags_hier`` plans for the same (arch, shape, workers, hardware) are
    different artifacts and must not collide in the cache."""
    return os.path.join(
        root,
        f"{arch}_{shape}_p{n_workers}_{train_mode}_t{tiers}_{hw_name}.json")


def summarize(sched: Schedule, classes: Sequence[tuple[str, tuple[str, ...]]]
              = (("embed", ("embed", "lm_head", "out")),
                 ("attention", ("attn", "wq", "wk", "wv", "wo")),
                 ("ffn", ("ffn", "mlp", "w1", "w2", "w3", "gate", "up",
                          "down")))) -> dict[str, dict]:
    """Group leaves into coarse classes by substring match on the path and
    report min/mean/max ratio per class (bench/report helper)."""
    out: dict[str, dict] = {}
    for cls, keys in classes:
        rs = [lp.ratio for lp in sched.leaves
              if any(k in lp.name.lower() for k in keys)]
        if rs:
            out[cls] = {"n": len(rs), "min": min(rs), "max": max(rs),
                        "mean": sum(rs) / len(rs)}
    return out
