"""Feed-forward blocks: gated (SwiGLU) and plain, as
``repro.models.ffn`` has them (weights (d, f) and (f, d))."""
from __future__ import annotations

import torch

from repro_torch.models import layers as L


def ffn_forward(p, x, activation: str = "silu"):
    act = L.ACTIVATIONS[activation]
    up = torch.einsum("...d,df->...f", x, p["w_up"].to(x.dtype))
    if "w_gate" in p:
        gate = torch.einsum("...d,df->...f", x, p["w_gate"].to(x.dtype))
        h = act(gate) * up
    else:
        h = act(up)
    return torch.einsum("...f,fd->...d", h, p["w_down"].to(x.dtype))
