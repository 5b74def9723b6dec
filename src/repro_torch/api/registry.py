"""String -> factory registry for exchange strategies, as
``repro.api.registry`` has it.

    @register_exchange("my_exchange")
    def _build(spec: ExchangeSpec):
        return MyExchange(ks=spec.ks, ...)

``dense`` and ``lags_dp`` build on both surfaces: the simulation surface
(``sim=True``) and the distributed data-parallel step (``sim=False``,
where ``lags_dp`` runs ``BlockLAGSExchange``).  The reference's other
modes are registered and raise ``NotImplementedError`` naming their
ROADMAP.md item.
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
class ExchangeSpec:
    """Everything a strategy factory may need to build an exchange."""
    mode: str
    params_like: Any                 # tree of tensors (shapes read)
    ratio: float = 250.0
    ks: Any = None                   # per-leaf k^(l) override
    block_size: int = 4096
    compressor: str = "topk_exact"
    selection_backend: str = "xla"   # "xla" | "kernel"
    sim: bool = False
    n_workers: int = 1
    # distributed-only layout hint (see lags.BlockLAGSExchange)
    shard_dims: Any = None
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
        if self.ks is not None:
            return self.ks
        return lags.ks_from_ratio(self.params_like, self.ratio)

    def resolved_compressor(self) -> str:
        """The compressor name the exchange runs: under the "kernel"
        backend each name maps to its kernel variant."""
        if self.selection_backend == "kernel":
            return C.kernel_backed(self.compressor)
        return self.compressor


#: Compressors that take the spec's ``block_size`` as a kwarg.
_BLOCK_SIZED = frozenset({
    "topk_hier", "topk_hier_kernel", "topk_hier_ef_kernel",
    "topk_block", "topk_block_kernel", "topk_block_ef_kernel",
})


def _sel_kwargs(name: str, spec: ExchangeSpec) -> tuple:
    if name in _BLOCK_SIZED:
        return (("block_size", spec.block_size),)
    return ()


_EXCHANGES: dict[str, Callable[[ExchangeSpec], Any]] = {}


def register_exchange(name: str):
    """Decorator: register ``factory(spec) -> exchange`` under ``name``."""
    def deco(factory):
        _EXCHANGES[name] = factory
        return factory
    return deco


def get_exchange(name: str) -> Callable[[ExchangeSpec], Any]:
    """The factory registered under ``name`` (legacy spellings accepted)."""
    key = canonical_mode(name)
    if key not in _EXCHANGES:
        raise KeyError(f"unknown exchange strategy {name!r}; registered: "
                       f"{sorted(_EXCHANGES)}")
    return _EXCHANGES[key]


def exchange_names() -> list[str]:
    return sorted(_EXCHANGES)


def build_exchange(spec: ExchangeSpec):
    return get_exchange(spec.mode)(spec)


@register_exchange("dense")
def _dense_factory(spec: ExchangeSpec):
    """Vanilla S-SGD baseline: dense mean over workers."""
    return lags.DenseExchange()


@register_exchange("lags_dp")
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
        C.get_compressor(name)      # an unported compressor raises here
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
        use_kernel=(spec.selection_backend == "kernel"))


def _unported(mode: str, item: str):
    def factory(spec):
        raise NotImplementedError(
            f"exchange mode {mode!r} is not ported yet (ROADMAP.md "
            f"queue 1 item {item})")
    register_exchange(mode)(factory)


_unported("slgs", "8: slgs")
_unported("lags_hier", "9: the hierarchy")
_unported("lags_hier2", "9: the hierarchy")
