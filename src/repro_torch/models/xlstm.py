"""The sLSTM block of ``repro.models.xlstm`` (arXiv:2405.04517): scalar
memory with a true hidden-state recurrence, exponential gating with the
max-stabiliser ``m``, run as a time loop.

Layouts are the reference's: ``w_gates`` (4, D, H, hd) and ``b_gates``
(4, H, hd) for the gates i, f, z, o; ``r_gates`` (4, H, hd, hd), the
head-local recurrent matrices; ``out_norm`` (D,), an RMS norm with
``(1 + scale)``; ``up_proj`` (D, 2·d_up) and ``down_proj`` (d_up, D),
``d_up = int(4/3 · D)``.  The recurrence and the gate projections run
in f32.  ``slstm_forward(state=, return_state=True)`` carries the
(c, n, m, h) state across calls: the serving engine's prefill and
one-token decode.  The mLSTM is not ported (ROADMAP.md queue 1 item
13d).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

SLSTM_PROJ = 4 / 3


def mlstm_forward(p, x, *, n_heads: int):
    raise NotImplementedError(
        "the mLSTM block is not ported yet (ROADMAP.md queue 1 item 13d: "
        "the mLSTM part of models/xlstm.py)")


def slstm_specs(d_model: int, n_heads: int) -> tuple[dict, dict]:
    """(leaf specs as (shape, init), logical axes) of one sLSTM block:
    ``init_slstm``'s shapes and scales (normal · scale, or zeros)."""
    hd = d_model // n_heads
    s = 1.0 / math.sqrt(d_model)
    sh = 1.0 / math.sqrt(hd)
    d_up = int(SLSTM_PROJ * d_model)
    specs = {
        "w_gates": ((4, d_model, n_heads, hd), s),
        "b_gates": ((4, n_heads, hd), L.ZEROS),
        "r_gates": ((4, n_heads, hd, hd), sh),
        "out_norm": ((d_model,), L.ZEROS),
        "up_proj": ((d_model, 2 * d_up), s),
        "down_proj": ((d_up, d_model), 1.0 / math.sqrt(d_up)),
    }
    axes = {
        "w_gates": (None, "embed", "heads", "head_dim"),
        "b_gates": (None, "heads", "head_dim"),
        "r_gates": (None, "heads", "head_dim", None),
        "out_norm": ("embed",),
        "up_proj": ("embed", "ffn"),
        "down_proj": ("ffn", "embed"),
    }
    return specs, axes


def _slstm_cell(state, gates_x, r_gates):
    """state: c, n, m, h, each (B, H, hd); gates_x: (4, B, H, hd)."""
    c, n, m, h = state
    rec = torch.einsum("bhk,ghkl->gbhl", h, r_gates)
    gi, gf, gz, go = gates_x + rec
    log_f = F.logsigmoid(gf)
    # torch.maximum splits the gradient of a tie evenly, as jnp.maximum does
    m_new = torch.maximum(log_f + m, gi)
    i_g = torch.exp(gi - m_new)
    f_g = torch.exp(log_f + m - m_new)
    z = torch.tanh(gz)
    o = torch.sigmoid(go)
    c = f_g * c + i_g * z
    n = f_g * n + i_g
    h_new = o * c / torch.maximum(n, torch.ones((), device=n.device))
    return (c, n, m_new, h_new), h_new


def _slstm_scan(p, x, n_heads: int, state=None):
    """x: (B, S, D) -> (h (B, S, D) f32, the final (c, n, m, h)).
    ``state``: the (c, n, m, h) to start from (zeros by default)."""
    b, s, d = x.shape
    hd = d // n_heads
    xf = x.float()
    gates = torch.einsum("bsd,gdhk->gbshk", xf, p["w_gates"].float()) \
        + p["b_gates"].float()[:, None, None]
    if state is None:
        # the stabiliser m starts at 0, as c, n and h
        state = init_slstm_state(b, d, n_heads, device=x.device)
    r = p["r_gates"].float()
    hs = []
    for t in range(s):
        state, h = _slstm_cell(state, gates[:, :, t], r)
        hs.append(h)
    return torch.stack(hs, dim=1).reshape(b, s, d), state


def slstm_forward(p, x, *, n_heads: int, state=None,
                  return_state: bool = False):
    """x: (B, S, D) -> (B, S, D) in x's dtype; with ``return_state`` also
    the final (c, n, m, h), each (B, H, hd) f32 (the decode state)."""
    h, new_state = _slstm_scan(p, x, n_heads, state)
    h = L.rms_norm(h, p["out_norm"])
    uz = torch.einsum("bsd,du->bsu", h.to(x.dtype), p["up_proj"].to(x.dtype))
    u, z = torch.chunk(uz, 2, dim=-1)
    out = torch.einsum("bsu,ud->bsd",
                       L.ACTIVATIONS["gelu"](u) * torch.sigmoid(z),
                       p["down_proj"].to(x.dtype))
    if return_state:
        return out, new_state
    return out


def init_slstm_state(batch: int, d_model: int, n_heads: int, *,
                     device="cuda"):
    """(c, n, m, h), each (B, H, hd) f32 zeros: the O(1) decode state."""
    z = torch.zeros((batch, n_heads, d_model // n_heads),
                    dtype=torch.float32, device=device)
    return (z, z.clone(), z.clone(), z.clone())


def slstm_state_axes():
    a = ("cache_batch", None, "head_dim")
    return (a, a, a, a)
