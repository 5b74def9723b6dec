"""Basic building blocks over explicit parameter trees, as
``repro.models.layers`` has them: RMS norm with ``(1 + scale)``, rotary
embedding on split halves, embedding, linear and the activations."""
from __future__ import annotations

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def apply_norm(kind: str, x, p):
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"norm {kind!r} is not ported yet (ROADMAP.md queue 1 item 13: "
            f"the remaining model families)")
    return rms_norm(x, p["scale"])


def squared_relu(x):
    r = F.relu(x)
    return r * r


ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "squared_relu": squared_relu,
}


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (seq,) integer."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)             # (hd/2,)
    angles = positions[..., None].float() * freqs              # (S, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed(p, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["embedding"].to(dtype)[tokens]


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32."""
    return torch.einsum("...d,vd->...v", x.float(), p["embedding"].float())


def linear(p, x):
    return torch.einsum("...i,io->...o", x, p["w"].to(x.dtype))
