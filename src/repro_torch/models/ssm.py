"""The Mamba block of ``repro.models.ssm``: the selective SSM of the
Jamba hybrid (arXiv:2403.19887).

An input projection gives ``x`` and a gate ``z``; a depthwise causal
conv of width ``D_CONV`` runs over ``x``; ``x_proj`` and ``dt_proj``
give the input-dependent (dt, B, C); the diagonal linear recurrence
h_t = exp(dt_t·A)·h_{t−1} + dt_t·B_t·x_t runs over ``D_STATE`` states
a channel; y = C·h + D·x, gated by silu(z), goes through ``out_proj``.

Layouts are the reference's, ``d_inner = EXPAND · d_model``:
``in_proj`` (D, 2·d_inner), ``conv_w`` (D_CONV, d_inner), ``conv_b``
(d_inner,), ``x_proj`` (d_inner, dt_rank + 2·D_STATE), ``dt_proj_w``
(dt_rank, d_inner), ``dt_proj_b`` (d_inner,), ``A_log`` (d_inner,
D_STATE) with A = −exp(A_log), ``D`` (d_inner,), ``out_proj`` (d_inner,
D).  The decode state is ``{"conv": (B, D_CONV − 1, d_inner)``, the
conv's input tail in the cache dtype, ``"ssm": (B, d_inner, D_STATE)``
f32``}``.

The projections run in the activation dtype; softplus, exp(dt·A), the
scan, D·x and the gate in f32, as in the reference.  The reference runs
the recurrence as ``jax.lax.associative_scan`` and lets autodiff keep
what it wants, ~2·log2(S) tensors of (B, S, d_inner, D_STATE) f32 a
layer.  Here :class:`_SelectiveScan` saves only its (B, S, d_inner) and
(B, S, D_STATE) inputs and recomputes the states in its backward.  It
scans a block of channels at a time (``SCAN_BLOCK`` f32 elements of (B,
S, channels, D_STATE)) in log2(S) doubling steps, so its transient is a
few blocks, whatever the depth.  Its products group differently from
``associative_scan``'s, so the port matches the reference to allclose.

Tensor parallelism: ``DTensor`` leaves on the 'model' mesh, laid out by
the reference's rules (``MAMBA_TP``: every leaf on its ``inner`` dim),
run each rank's channels on local tensors between the boundaries of
``models.tp`` (``mamba_forward``, and ``mamba_decode`` on the rank's
channels of the decode state); the data-only path runs the same code
with ``mesh=None``, where every boundary is the identity.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import tp as TP
from repro_torch.sharding.dtensor import is_dtensor

D_STATE = 16
D_CONV = 4
EXPAND = 2
#: f32 elements of (B, S, channels, D_STATE) in one block of the scan
#: (256 MiB); its backward holds about five blocks at once
SCAN_BLOCK = 1 << 26


def dt_rank(d_model: int) -> int:
    return max(1, d_model // 16)


def _dt_bias(d_inner: int) -> torch.Tensor:
    """``dt_proj_b``: softplus⁻¹ of linspace(0.001, 0.1), by the
    reference's f32 formula.  XLA's exp and log round apart from
    torch's by an ulp here and there, and exp(x) − 1 near x = 0.001
    cancels ~10 bits, so the two agree to ~4e-5, not bit for bit."""
    lin = torch.linspace(0.001, 0.1, d_inner, dtype=torch.float32)
    return torch.log(torch.exp(lin) - 1.0)


def _a_log(d_inner: int) -> torch.Tensor:
    """``A_log``: log(1 … D_STATE) in every channel."""
    return torch.log(torch.arange(1, D_STATE + 1, dtype=torch.float32)
                     ).repeat(d_inner, 1)


def mamba_specs(d_model: int) -> tuple[dict, dict]:
    """(leaf specs as (shape, init), logical axes) of one Mamba block:
    ``init_mamba``'s shapes, scales, constants and computed leaves."""
    d_inner = EXPAND * d_model
    r = dt_rank(d_model)
    s, si = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_inner)
    specs = {
        "A_log": ((d_inner, D_STATE),
                  L.Values(functools.partial(_a_log, d_inner))),
        "D": ((d_inner,), L.ONES),
        "conv_b": ((d_inner,), L.ZEROS),
        "conv_w": ((D_CONV, d_inner), 0.1),
        "dt_proj_b": ((d_inner,),
                      L.Values(functools.partial(_dt_bias, d_inner))),
        "dt_proj_w": ((r, d_inner), 1.0 / math.sqrt(r)),
        "in_proj": ((d_model, 2 * d_inner), s),
        "out_proj": ((d_inner, d_model), si),
        "x_proj": ((d_inner, r + 2 * D_STATE), si),
    }
    axes = {
        "A_log": ("inner", None),
        "D": ("inner",),
        "conv_b": ("inner",),
        "conv_w": (None, "inner"),
        "dt_proj_b": ("inner",),
        "dt_proj_w": (None, "inner"),
        "in_proj": ("embed", "inner"),
        "out_proj": ("inner", "embed"),
        "x_proj": ("inner", None),
    }
    return specs, axes


def _ssm_params(p, x, mesh=None):
    """x: (B, S, d_inner) -> dt (B, S, d_inner), Bm and Cm (B, S,
    D_STATE), all f32.  ``mesh`` (tensor parallelism): ``x`` holds this
    rank's channels, ``p`` its rows of ``x_proj`` and its columns of
    ``dt_proj_w``; the partial (dt, B, C) are summed over 'model' (in
    f32) before softplus, and dt is this rank's channels."""
    r = p["dt_proj_w"].shape[0]
    proj = TP.all_sum(torch.einsum("bsi,ir->bsr", x, p["x_proj"].to(x.dtype)),
                      mesh)
    dt, Bm, Cm = torch.split(proj, [r, D_STATE, D_STATE], dim=-1)
    dt = torch.einsum("bsr,ri->bsi", dt, p["dt_proj_w"].to(x.dtype))
    dt = F.softplus(dt.float() + p["dt_proj_b"].float())
    return dt, Bm.float(), Cm.float()


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv of width ``D_CONV``.  x: (B, S, I);
    ``state``: the (B, D_CONV − 1, I) input tail before it (zeros
    without one).  Returns (y, the new tail)."""
    if state is None:
        pad = x.new_zeros((x.shape[0], D_CONV - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                          # (B, S+3, I)
    s = x.shape[1]
    w = w.to(x.dtype)
    y = xp[:, :s] * w[0]
    for i in range(1, D_CONV):
        y = y + xp[:, i:i + s] * w[i]
    return y + b.to(x.dtype), xp[:, -(D_CONV - 1):]


def _doubling(a, b, reverse: bool) -> None:
    """In place along dim 1: ``b`` becomes the scan of h_t = a_t·h_{t−1}
    + b_t from h = 0 (``reverse``: h_t = a_t·h_{t+1} + b_t from the end);
    ``a`` is spent.  log2(S) steps, each combining element t with the
    one ``d`` before (after) it; each right-hand side is materialised
    before it is written back, so no write overlaps its own read."""
    s = a.shape[1]
    d = 1
    while d < s:
        if reverse:
            b[:, :-d] += a[:, :-d] * b[:, d:]
            if 2 * d < s:
                a[:, :-d] = a[:, :-d] * a[:, d:]
        else:
            b[:, d:] += a[:, d:] * b[:, :-d]
            if 2 * d < s:
                a[:, d:] = a[:, d:] * a[:, :-d]
        d *= 2


def _states(dt, A, Bm, x):
    """h (B, S, C, D_STATE) of a block of C channels, from zeros:
    a = exp(dt·A), b = dt·Bm·x, as the reference forms them."""
    a = torch.exp(dt[..., None] * A)
    h = dt[..., None] * Bm[:, :, None, :] * x[..., None]
    _doubling(a, h, reverse=False)
    return h


def _blocks(rows: int, channels: int, block: int) -> list:
    step = max(1, min(channels, block // (rows * D_STATE)))
    return [(lo, min(channels, lo + step))
            for lo in range(0, channels, step)]


class _SelectiveScan(torch.autograd.Function):
    """(dt (B, S, I), A (I, N), Bm (B, S, N), Cm (B, S, N), x (B, S, I),
    all f32) -> (y = Σ_n h·Cm (B, S, I), the last state h_S (B, I, N)),
    h_t = exp(dt_t·A)·h_{t−1} + dt_t·Bm_t·x_t from h_0 = 0.

    Saves its inputs only.  The backward recomputes h a block of
    channels at a time and runs the reverse recurrence g_t = Cm_t·dy_t +
    a_{t+1}·g_{t+1} (g_S gains the last state's gradient); g is the
    gradient of b_t = dt·Bm·x and g_t·h_{t−1} that of a_t, from which
    those of dt, A, Bm, Cm and x follow."""

    @staticmethod
    def forward(ctx, dt, A, Bm, Cm, x, block):
        b, s, n_ch = dt.shape
        y = torch.empty_like(dt)
        last = dt.new_empty((b, n_ch, D_STATE))
        if dt.device.type != "meta":
            for lo, hi in _blocks(b * s, n_ch, block):
                h = _states(dt[..., lo:hi], A[lo:hi], Bm, x[..., lo:hi])
                y[..., lo:hi] = torch.einsum("bsin,bsn->bsi", h, Cm)
                last[:, lo:hi] = h[:, -1]
        ctx.save_for_backward(dt, A, Bm, Cm, x)
        ctx.block = block
        return y, last

    @staticmethod
    def backward(ctx, dy, dlast):
        dt, A, Bm, Cm, x = ctx.saved_tensors
        b, s, n_ch = dt.shape
        d_dt, dx = torch.empty_like(dt), torch.empty_like(x)
        dA = torch.empty_like(A)
        dBm, dCm = torch.zeros_like(Bm), torch.zeros_like(Cm)
        if dy is None:
            dy = torch.zeros_like(dt)
        for lo, hi in _blocks(b * s, n_ch, ctx.block):
            dt_c, x_c, A_c, dy_c = (dt[..., lo:hi], x[..., lo:hi], A[lo:hi],
                                    dy[..., lo:hi])
            h = _states(dt_c, A_c, Bm, x_c)
            dCm += torch.einsum("bsin,bsi->bsn", h, dy_c)
            g = dy_c[..., None] * Cm[:, :, None, :]
            if dlast is not None:
                g[:, -1] += dlast[:, lo:hi]
            a = torch.exp(dt_c[..., None] * A_c)
            a_next = torch.empty_like(a)
            a_next[:, :-1] = a[:, 1:]
            a_next[:, -1] = 0.0
            _doubling(a_next, g, reverse=True)
            del a_next
            # q_t = g_t·h_{t−1}·a_t, the gradient of a_t times a_t (in
            # h's storage; h_0 = 0)
            h[:, 1:] = h[:, :-1] * a[:, 1:]
            h[:, 0] = 0.0
            q = h.mul_(g)
            del a
            gB = torch.einsum("bsin,bsn->bsi", g, Bm)
            d_dt[..., lo:hi] = (q * A_c).sum(-1) + x_c * gB
            dA[lo:hi] = (q * dt_c[..., None]).sum((0, 1))
            dBm += torch.einsum("bsin,bsi->bsn", g, dt_c * x_c)
            dx[..., lo:hi] = dt_c * gB
            del h, g, q
        return d_dt, dA, dBm, dCm, dx, None


def selective_scan(dt, A, Bm, Cm, x):
    """(y (B, S, I), the last state (B, I, N)) in blocks of
    ``SCAN_BLOCK``: see :class:`_SelectiveScan`."""
    return _SelectiveScan.apply(dt, A, Bm, Cm, x, SCAN_BLOCK)


def _mamba(p, x, mesh=None):
    """The Mamba block -> (out, the conv tail, the last SSM state); with
    ``mesh``, this rank's part on its chunks ``p`` (``mamba_forward``):
    a partial output."""
    xz = torch.einsum("bsd,di->bsi", x, p["in_proj"].to(x.dtype))
    xi, z = TP.split_pair(xz, mesh)
    xi, conv = _causal_conv(xi, p["conv_w"], p["conv_b"])
    xi = F.silu(xi)
    dt, Bm, Cm = _ssm_params(p, xi, mesh)
    A = -torch.exp(p["A_log"].float())
    xf = xi.float()
    y, last = selective_scan(dt, A, Bm, Cm, xf)
    y = y + xf * p["D"].float()
    y = y * F.silu(z.float())
    out = torch.einsum("bsi,id->bsd", y.to(x.dtype),
                       p["out_proj"].to(x.dtype))
    return out, conv, last


#: the Mamba block's leaves on 'model' (``TP_PRIORITY``: "inner"): the
#: dim each is split on
MAMBA_TP = {"A_log": 0, "D": 0, "conv_b": 0, "conv_w": 1, "dt_proj_b": 0,
            "dt_proj_w": 1, "in_proj": 1, "out_proj": 0, "x_proj": 0}


def mamba_forward(p, x, *, return_state: bool = False):
    """x: (B, S, D) -> (B, S, D) in x's dtype; with ``return_state`` also
    the final ``{"conv", "ssm"}`` (the reference's ``_mamba_prefill``):
    the decode state after the sequence.

    ``DTensor`` leaves on the 'model' mesh (laid out as ``MAMBA_TP``)
    run this rank's channels on local tensors: ``in_proj``'s output
    gathered for its channels of x and z (``models.tp.split_pair``), the
    conv, ``dt_proj`` and the scan (``_SelectiveScan`` unchanged) on
    them, ``x_proj``'s partial (dt, B, C) summed over 'model' before
    softplus, ``out_proj``'s partial output summed in f32.  x is
    replicated over 'model' (its gradient comes back ``Partial``); the
    output is a replicated ``DTensor``, and the state this rank's
    channels of it (``DTensor``s split on ``d_inner``, the rules'
    ``mamba_state_axes``)."""
    mesh = None
    if is_dtensor(p["in_proj"]):
        mesh, p = TP.local_leaves(p, MAMBA_TP, "Mamba")
        x = TP.tokens_local(x, mesh, True)
    out, conv, last = _mamba(p, x, mesh)
    if mesh is not None:
        out = TP.replicated_sum(out, mesh)
    if return_state:
        return out, {"conv": TP.state_shard(conv.clone(), mesh, 2),
                     "ssm": TP.state_shard(last, mesh, 1)}
    return out


def init_mamba_state(batch: int, d_model: int, dtype: torch.dtype, *,
                     device="cuda") -> dict:
    """The zero decode state: ``conv`` (B, D_CONV − 1, d_inner) in
    ``dtype``, ``ssm`` (B, d_inner, D_STATE) f32."""
    d_inner = EXPAND * d_model
    return {"conv": torch.zeros((batch, D_CONV - 1, d_inner), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, d_inner, D_STATE),
                               dtype=torch.float32, device=device)}


def mamba_state_axes() -> dict:
    return {"conv": ("cache_batch", None, "inner"),
            "ssm": ("cache_batch", "inner", None)}


def mamba_decode(p, x, state):
    """One token.  x: (B, 1, D); ``state``: ``{"conv", "ssm"}``.
    Returns (out (B, 1, D), the new state; ``conv`` in the state's
    dtype).  ``DTensor`` leaves on the 'model' mesh run this rank's
    channels as :func:`mamba_forward` does, on its chunks of the state
    (split on ``d_inner``); the new state is its chunks again."""
    mesh = None
    if is_dtensor(p["in_proj"]):
        mesh, p = TP.local_leaves(p, MAMBA_TP, "Mamba")
        x = TP.tokens_local(x, mesh, True)
    conv0, h0 = TP.state_local(state["conv"]), TP.state_local(state["ssm"])
    xz = torch.einsum("bsd,di->bsi", x, p["in_proj"].to(x.dtype))
    xi, z = TP.split_pair(xz, mesh)
    xi, conv = _causal_conv(xi, p["conv_w"], p["conv_b"], conv0)
    xi = F.silu(xi)
    dt, Bm, Cm = _ssm_params(p, xi, mesh)
    A = -torch.exp(p["A_log"].float())
    xf = xi.float()[:, 0]                                     # (B, I)
    dt0, Bm0, Cm0 = dt[:, 0], Bm[:, 0], Cm[:, 0]
    a = torch.exp(dt0[..., None] * A)                         # (B, I, N)
    h = h0 * a + dt0[..., None] * Bm0[:, None, :] * xf[..., None]
    y = torch.einsum("bin,bn->bi", h, Cm0) + xf * p["D"].float()
    y = y * F.silu(z.float()[:, 0])
    out = torch.einsum("bi,id->bd", y.to(x.dtype),
                       p["out_proj"].to(x.dtype))[:, None]
    if mesh is not None:
        out = TP.replicated_sum(out, mesh)
    return out, {"conv": TP.state_shard(conv.to(conv0.dtype), mesh, 2),
                 "ssm": TP.state_shard(h, mesh, 1)}
