"""String -> factory registry for exchange strategies, as
``repro.api.registry`` has it.

    @register_exchange("my_exchange")
    def _build(spec: ExchangeSpec):
        return MyExchange(ks=spec.ks, ...)

This slice builds ``dense`` and ``lags_dp`` on the simulation surface
(``sim=True``); the reference's other modes are registered and raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

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


def _sim_only(spec: ExchangeSpec) -> None:
    if not spec.sim:
        raise NotImplementedError(
            f"{spec.mode}: the distributed surface is not ported yet "
            f"(ROADMAP.md queue 1 item 7)")


@register_exchange("dense")
def _dense_factory(spec: ExchangeSpec):
    """Vanilla S-SGD baseline: dense mean over workers."""
    _sim_only(spec)
    return lags.DenseExchange()


@register_exchange("lags_dp")
def _lags_factory(spec: ExchangeSpec):
    """Layer-wise adaptive sparsification (the paper), simulation
    surface: the per-leaf compressor, resolved through
    ``selection_backend``."""
    _sim_only(spec)
    name = spec.resolved_compressor()
    return lags.LAGSExchange(ks=spec.resolved_ks(), compressor_name=name,
                             compressor_kwargs=_sel_kwargs(name, spec))


def _unported(mode: str, item: str):
    def factory(spec):
        raise NotImplementedError(
            f"exchange mode {mode!r} is not ported yet (ROADMAP.md "
            f"queue 1 item {item})")
    register_exchange(mode)(factory)


_unported("slgs", "8: slgs")
_unported("lags_hier", "9: the hierarchy")
_unported("lags_hier2", "9: the hierarchy")
