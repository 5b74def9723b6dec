"""Public surface of the port: ``RunConfig``, ``Session`` and the
exchange registry."""
from repro_torch.api.config import RunConfig, canonical_mode
from repro_torch.api.registry import (ExchangeSpec, TieredKs,
                                      build_exchange, exchange_names,
                                      get_exchange, register_exchange,
                                      resolve_schedule_ks)
from repro_torch.api.session import Session, build_train_step

__all__ = ["ExchangeSpec", "RunConfig", "Session", "TieredKs",
           "build_exchange", "build_train_step", "canonical_mode",
           "exchange_names", "get_exchange", "register_exchange",
           "resolve_schedule_ks"]
