"""PyTorch/CUDA port of LAGS-SGD (layer-wise adaptive gradient
sparsification), laid out module for module like ``repro``.

``repro`` (JAX/Pallas) stays the reference; this package imports
neither it nor JAX.  The selection kernels of the training path are
hand-written CUDA C++ for Hopper (``repro_torch.kernels``); everything
around them is plain PyTorch.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the CPU tests do).  Asking for ``cuda`` without a card raises — there is
no silent CPU fallback.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises when ``cuda`` is asked
    for and no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev
