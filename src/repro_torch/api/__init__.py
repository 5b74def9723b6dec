"""Public surface of the port: ``RunConfig``, ``Session`` and the
exchange and compressor registries, the names of ``repro.api``
(``resolve_schedule_ks`` is importable here too)."""
from repro_torch.api.config import RunConfig, canonical_mode
from repro_torch.api.registry import (ExchangeSpec, ExchangeStrategy,
                                      TieredKs, build_exchange,
                                      compressor_names, exchange_names,
                                      get_compressor, get_exchange,
                                      register_compressor,
                                      register_exchange,
                                      resolve_schedule_ks)
from repro_torch.api.session import Session, build_train_step

__all__ = [
    "RunConfig", "canonical_mode", "ExchangeSpec", "ExchangeStrategy",
    "TieredKs", "build_exchange", "compressor_names", "exchange_names",
    "get_compressor", "get_exchange", "register_compressor",
    "register_exchange", "Session", "build_train_step",
]
