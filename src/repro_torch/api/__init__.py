"""Public surface of the port: ``RunConfig``, ``Session`` and the
exchange registry."""
from repro_torch.api.config import RunConfig, canonical_mode
from repro_torch.api.registry import (ExchangeSpec, build_exchange,
                                      exchange_names, get_exchange,
                                      register_exchange)
from repro_torch.api.session import Session

__all__ = ["ExchangeSpec", "RunConfig", "Session", "build_exchange",
           "canonical_mode", "exchange_names", "get_exchange",
           "register_exchange"]
