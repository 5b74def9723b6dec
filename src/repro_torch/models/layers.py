"""Basic building blocks over explicit parameter trees, as
``repro.models.layers`` has them: RMS norm with ``(1 + scale)``, layer
norm, rotary embedding on split halves, embedding, linear and the
activations."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Full:
    """The init of a (shape, init) leaf spec that is not a normal's
    scale: every entry ``value`` (``jnp.full``)."""
    value: float


ZEROS, ONES = Full(0.0), Full(1.0)


@dataclasses.dataclass(frozen=True)
class Values:
    """The init of a (shape, init) leaf spec whose entries are computed,
    not drawn: ``fn()`` gives one layer's f32 values on the host, which
    a stacked leaf repeats along its leading ``layers`` axis."""
    fn: Callable[[], torch.Tensor]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


NORMS = ("rmsnorm", "layernorm")


def apply_norm(kind: str, x, p):
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    if kind == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    raise ValueError(f"norm {kind!r} not in {NORMS}")


def norm_specs(kind: str, shape: tuple) -> dict:
    """A norm's leaves as (shape, init) specs (``init_norm``'s
    semantics): rmsnorm ``{"scale": zeros}``, since it scales by ``1 +
    scale``; layernorm ``{"scale": ones, "bias": zeros}``."""
    if kind == "rmsnorm":
        return {"scale": (shape, ZEROS)}
    if kind == "layernorm":
        return {"scale": (shape, ONES), "bias": (shape, ZEROS)}
    raise ValueError(f"norm {kind!r} not in {NORMS}")


def norm_axes(kind: str, axes: tuple) -> dict:
    """The logical axes of :func:`norm_specs`' leaves."""
    return {name: axes for name in norm_specs(kind, ())}


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
