"""String -> strategy registry for exchanges, as ``repro.api.registry``
has it.

    @register_exchange("my_exchange")
    def _build(spec: ExchangeSpec):
        return MyExchange(ks=spec.ks, ...)

Every strategy of the reference builds on both surfaces: the simulation
surface (``sim=True``) and the distributed step (``sim=False``, where
``lags_dp`` and ``lags_hier`` run ``BlockLAGSExchange`` and
``lags_hier2`` the two-tier ``SparseHierLAGSExchange``).  An autotuned
schedule reaches a factory through :func:`resolve_schedule_ks` (the
per-leaf k tree, or a :class:`TieredKs` for the two-tier modes) as
``ExchangeSpec.ks``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.api.config import canonical_mode
from repro_torch.core import compressors as C
from repro_torch.core import lags


@dataclasses.dataclass(frozen=True)
class TieredKs:
    """Two-tier per-leaf budgets (deliberately not a tree):
    ``resolve_schedule_ks`` packs a ``HierSchedule``'s two k trees into
    one for the strategies that consume both tiers (``ef_tiers``, i.e.
    ``lags_hier2``); either may be None, and that tier then falls back
    to the spec's scalar ratio."""
    inner: Any = None
    outer: Any = None


@dataclasses.dataclass(frozen=True)
class ExchangeSpec:
    """Everything a strategy factory may need to build an exchange."""
    mode: str
    params_like: Any                 # tree of tensors (shapes read)
    ratio: float = 250.0
    ks: Any = None                   # per-leaf k^(l) override (schedule),
                                     # or a TieredKs for two-tier modes
    block_size: int = 4096
    compressor: str = "topk_exact"
    selection_backend: str = "xla"   # "xla" | "kernel"
    # lags_hier2 inner-tier compressor override (None = ``compressor``)
    inner_compressor: str | None = None
    sim: bool = False
    n_workers: int = 1
    # two-tier (lags_hier2) knobs: the intra-pod ratio, and how many of
    # the n_workers share a pod (simulation; the distributed step reads
    # the mesh)
    ratio_inner: float = 1.0
    n_inner: int = 1
    # distributed-only layout hint (see lags.BlockLAGSExchange)
    shard_dims: Any = None
    # distributed-only: the 'model' axis (a lags.Axes) whose ranks each
    # hold a chunk of the leaves ``shard_dims`` shards (tensor
    # parallelism; None = whole leaves)
    row_axes: Any = None
    # DGC momentum correction factor (the velocity accumulates BEFORE
    # sparsification); > 0 turns on the per-worker "mom" extra state
    momentum_correction: float = 0.0

    def init_extra_state(self, updates_like=None):
        """Per-worker auxiliary exchange state beyond the EF residual:
        ``{"mom": zeros (n_workers, ...) f32 tree}`` when
        ``momentum_correction > 0``, else ``{}``.  ``updates_like``
        (leaves with ``shape`` and ``device``) defaults to
        ``params_like``."""
        like = self.params_like if updates_like is None else updates_like
        extra: dict[str, Any] = {}
        if self.momentum_correction > 0.0:
            n_w = max(1, int(self.n_workers))
            extra["mom"] = tree.map(lambda x: torch.zeros(
                (n_w,) + tuple(x.shape), dtype=torch.float32,
                device=x.device), like)
        return extra

    def resolved_ks(self):
        """The per-leaf budget tree of the (outer) sparse exchange:
        the schedule's, or from the scalar ratio."""
        ks = self.ks.outer if isinstance(self.ks, TieredKs) else self.ks
        if ks is not None:
            return ks
        return lags.ks_from_ratio(self.params_like, self.ratio)

    def resolved_ks_inner(self):
        """The intra-pod tier's budget tree (two-tier modes): the
        schedule's inner tier, or from ``ratio_inner`` (1.0 = dense)."""
        if isinstance(self.ks, TieredKs) and self.ks.inner is not None:
            return self.ks.inner
        return lags.ks_from_ratio(self.params_like, self.ratio_inner)

    def resolved_compressor(self, *, inner: bool = False) -> str:
        """The compressor name the exchange runs: under the "kernel"
        backend each name maps to its kernel variant.  ``inner=True``
        resolves the lags_hier2 intra-pod tier (``inner_compressor``)."""
        name = (self.inner_compressor or self.compressor) if inner \
            else self.compressor
        if self.selection_backend == "kernel":
            return C.kernel_backed(name)
        return name


#: Compressors that take the spec's ``block_size`` as a kwarg.
_BLOCK_SIZED = frozenset({
    "topk_hier", "topk_hier_kernel", "topk_hier_ef_kernel",
    "topk_block", "topk_block_kernel", "topk_block_ef_kernel",
})


def _sel_kwargs(name: str, spec: ExchangeSpec) -> tuple:
    if name in _BLOCK_SIZED:
        return (("block_size", spec.block_size),)
    return ()


@dataclasses.dataclass(frozen=True)
class ExchangeStrategy:
    """A registered strategy: its factory, its axis plan and its EF-state
    layout.

    ``axes`` says which mesh axes the distributed step's workers span:

      * ``"data_manual"``: every rank of the data axes ('pod', 'data') is
        a worker with its own gradient (dense, lags_dp, slgs, lags_hier2);
      * ``"pod_auto"``: one worker per pod: the ranks of a pod take the
        dense mean of their updates, then the exchange runs over 'pod'
        (lags_hier; the reference's pure-auto GSPMD plan);
      * ``"none"``: a single worker, no exchange axes.

    ``ef_tiers``: ``()`` = one residual tree; a non-empty tuple of tier
    names means the exchange's state is ``{tier: residual_tree}`` (the
    two-tier ``lags_hier2``), which the state specs replicate once per
    tier and the pipeline's ``flatten_state`` must be told about."""
    name: str
    factory: Callable[[ExchangeSpec], Any]
    axes: str = "data_manual"
    ef_tiers: tuple = ()


_EXCHANGES: dict[str, ExchangeStrategy] = {}


def register_exchange(name: str, *, axes: str = "data_manual",
                      ef_tiers: tuple = ()):
    """Decorator: register ``factory(spec) -> exchange`` under ``name``."""
    if axes not in ("data_manual", "pod_auto", "none"):
        raise ValueError(f"unknown axes plan {axes!r}")

    def deco(factory):
        _EXCHANGES[name] = ExchangeStrategy(name=name, factory=factory,
                                            axes=axes,
                                            ef_tiers=tuple(ef_tiers))
        return factory
    return deco


def get_exchange(name: str) -> ExchangeStrategy:
    """The strategy registered under ``name`` (legacy spellings
    accepted)."""
    key = canonical_mode(name)
    if key not in _EXCHANGES:
        raise KeyError(f"unknown exchange strategy {name!r}; registered: "
                       f"{sorted(_EXCHANGES)}")
    return _EXCHANGES[key]


def exchange_names() -> list[str]:
    return sorted(_EXCHANGES)


def build_exchange(spec: ExchangeSpec):
    return get_exchange(spec.mode).factory(spec)


def resolve_schedule_ks(schedule, mode: str, params_like, *,
                        n_workers: int | None = None):
    """Validate and ingest an autotuned schedule, the one sequence both
    surfaces run (``validate_for``, then ``ks_tree``).  Returns the
    per-leaf k tree, a :class:`TieredKs` for the strategies registered
    with ``ef_tiers``, or None when there is nothing to ingest (no
    schedule, or the dense mode)."""
    if schedule is None or mode == "dense":
        return None
    from repro_torch.autotune import schedule as SCH
    SCH.validate_for(schedule, mode, n_workers=n_workers)
    strat = _EXCHANGES.get(canonical_mode(mode))
    if strat is not None and strat.ef_tiers:
        tiers = getattr(schedule, "tiers", None)
        if tiers is not None:        # HierSchedule: both tiers consumed
            return TieredKs(inner=tiers["inner"].ks_tree(params_like),
                            outer=tiers["outer"].ks_tree(params_like))
        if getattr(schedule, "tier", "") == "inner":
            # a lone inner-tier plan budgets the intra-pod exchange
            # only; the outer tier falls back to the scalar ratio
            return TieredKs(inner=schedule.ks_tree(params_like))
        return TieredKs(outer=schedule.ks_tree(params_like))
    return schedule.ks_tree(params_like)


@register_exchange("dense")
def _dense_factory(spec: ExchangeSpec):
    """Vanilla S-SGD baseline: dense mean over workers."""
    return lags.DenseExchange()


@register_exchange("slgs")
def _slgs_factory(spec: ExchangeSpec):
    """Single-layer (whole-model-vector) global top-k baseline:
    ``k_total = round(d_total / ratio)`` on both surfaces."""
    d_total = sum(lags._size(x) for x in tree.leaves(spec.params_like))
    name = spec.resolved_compressor()
    return lags.SLGSExchange(
        k_total=max(1, int(round(d_total / spec.ratio))),
        compressor_name=name, compressor_kwargs=_sel_kwargs(name, spec))


def _lags_factory(spec: ExchangeSpec):
    """Layer-wise adaptive sparsification (the paper).

    Simulation uses the per-leaf compressor (``LAGSExchange``, resolved
    through ``selection_backend``); the distributed step uses the block
    layout (``BlockLAGSExchange``), whose selection operator is block
    top-k, with the fused ``ef_select_pack`` kernel under the "kernel"
    backend."""
    ks = spec.resolved_ks()
    if spec.sim:
        name = spec.resolved_compressor()
        return lags.LAGSExchange(ks=ks, compressor_name=name,
                                 compressor_kwargs=_sel_kwargs(name, spec))
    if spec.compressor not in ("topk_exact", "topk_block",
                               "topk_block_kernel", "topk_block_ef_kernel"):
        # a run validated in simulation under another compressor deploys
        # with a different selection operator
        warnings.warn(
            f"distributed lags ignores compressor={spec.compressor!r}: "
            f"the production exchange selects via block top-k "
            f"(BlockLAGSExchange); simulate with compressor='topk_exact' "
            f"for the closest semantics match", stacklevel=3)
    return lags.BlockLAGSExchange(
        ks=ks, block_size=spec.block_size, shard_dims=spec.shard_dims,
        row_axes=spec.row_axes,
        use_kernel=(spec.selection_backend == "kernel"))


register_exchange("lags_dp")(_lags_factory)
# lags_hier shares the exchange; what differs is the axis plan: one
# worker per pod, whose update is the dense mean of its ranks', and the
# sparse exchange across pods
register_exchange("lags_hier", axes="pod_auto")(_lags_factory)


@register_exchange("lags_hier2", axes="data_manual",
                   ef_tiers=("inner", "outer"))
def _hier2_factory(spec: ExchangeSpec):
    """Two-level sparse hierarchy: a sparse intra-pod exchange with its
    own per-leaf ``ks_inner`` and residual, then the sparse cross-pod
    exchange of the pod mean with a second residual.  One exchange class
    serves both surfaces.  ``spec.inner_compressor`` (default
    ``spec.compressor``) selects on each worker's own gradient, the
    outer compressor on the pod mean; both resolve through
    ``selection_backend``."""
    outer_name = spec.resolved_compressor()
    inner_name = spec.resolved_compressor(inner=True)
    return lags.SparseHierLAGSExchange(
        ks=spec.resolved_ks(), ks_inner=spec.resolved_ks_inner(),
        n_inner=max(1, int(spec.n_inner)),
        compressor_name=outer_name,
        compressor_kwargs=_sel_kwargs(outer_name, spec),
        inner_compressor_name=(
            inner_name if inner_name != outer_name else None),
        inner_compressor_kwargs=_sel_kwargs(inner_name, spec))


# ---------------------------------------------------------------------------
# compressor registry (backed by core.compressors)
# ---------------------------------------------------------------------------

def register_compressor(name: str, compress=None, *, needs_key: bool = False,
                        fused_select=None):
    """Register a compressor ``compress(x, k, **kw) -> (values, indices)``.

    Usable as a decorator (``@register_compressor("name")``) or a plain
    call.  Entries land in ``core.compressors.REGISTRY``, so every
    strategy (and every ``compressor_name=`` field, the stream codec's
    too) can name them.  ``fused_select`` optionally provides the
    one-pass variant ``(u, e, k, **kw) -> (values, indices, residual)``
    that ``lags.local_select_ef`` prefers."""
    def add(fn):
        C.REGISTRY[name] = C.Compressor(name, fn, needs_key=needs_key,
                                        fused_select=fused_select)
        return fn
    if compress is None:
        return add
    return add(compress)


get_compressor = C.get_compressor


def compressor_names() -> list[str]:
    return sorted(C.REGISTRY)
