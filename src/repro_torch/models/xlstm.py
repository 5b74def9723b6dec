"""The xLSTM blocks of ``repro.models.xlstm`` (arXiv:2405.04517): the
mLSTM (matrix memory) and the sLSTM (scalar memory with a true
hidden-state recurrence), both with exponential gating under the
max-stabiliser ``m``.

The reference runs both as ``lax.scan`` time loops.  Here the mLSTM's
recurrence, linear in its state, runs a chunk of steps at a time in
closed form (``_mlstm_chunk``: the same stabiliser and denominator), and
the sLSTM's, nonlinear, runs as a time loop whose backward is written
out (``_SLSTMScan``).  Under autograd both loops cost ~360 kernels a
token a layer: 73–107 s a training step of xLSTM-1.3B at 512 tokens on
an NVIDIA H100 80GB HBM3 at 700.00 W (``PERF.md``).

mLSTM layouts are the reference's: ``up_proj`` (D, 2·d_inner),
``d_inner = 2·D``; ``wq``/``wk``/``wv`` (d_inner, H, hd), ``hd =
d_inner / H``; ``w_igate``/``w_fgate`` (d_inner, H) and their biases
(H,), filled with −10 and 3; ``out_norm`` (d_inner,) and ``down_proj``
(d_inner, D).  Its state is (C (B, H, hd, hd), n (B, H, hd), m (B, H)).

sLSTM layouts: ``w_gates`` (4, D, H, hd) and ``b_gates`` (4, H, hd) for
the gates i, f, z, o; ``r_gates`` (4, H, hd, hd), the head-local
recurrent matrices; ``out_norm`` (D,), an RMS norm with ``(1 +
scale)``; ``up_proj`` (D, 2·d_up) and ``down_proj`` (d_up, D), ``d_up =
int(4/3 · D)``.  Its state is (c, n, m, h), each (B, H, hd).

The recurrences and the gate projections run in f32.
``*_forward(state=, return_state=True)`` carries the state across
calls: the serving engine's prefill and one-token decode.

Tensor parallelism: ``DTensor`` leaves on the 'model' mesh, laid out by
the reference's rules (``MLSTM_TP``, ``SLSTM_TP``), run each rank's heads
on local tensors between the boundaries of ``models.tp`` (DTensor has
no rule for ``log_sigmoid_backward`` nor for the sLSTM's written-out
scan).  The data-only path runs the same code with ``mesh=None``, where
every boundary is the identity.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import tp as TP
from repro_torch.sharding.dtensor import is_dtensor

MLSTM_EXPAND = 2
SLSTM_PROJ = 4 / 3


def mlstm_specs(d_model: int, n_heads: int) -> tuple[dict, dict]:
    """(leaf specs as (shape, init), logical axes) of one mLSTM block:
    ``init_mlstm``'s shapes, scales and constants."""
    d_inner = MLSTM_EXPAND * d_model
    hd = d_inner // n_heads
    s = 1.0 / math.sqrt(d_model)
    si = 1.0 / math.sqrt(d_inner)
    specs = {
        "up_proj": ((d_model, 2 * d_inner), s),
        "wq": ((d_inner, n_heads, hd), si),
        "wk": ((d_inner, n_heads, hd), si),
        "wv": ((d_inner, n_heads, hd), si),
        "w_igate": ((d_inner, n_heads), si * 0.1),
        "b_igate": ((n_heads,), L.Full(-10.0)),
        "w_fgate": ((d_inner, n_heads), si * 0.1),
        "b_fgate": ((n_heads,), L.Full(3.0)),
        "out_norm": ((d_inner,), L.ZEROS),
        "down_proj": ((d_inner, d_model), si),
    }
    axes = {
        "up_proj": ("embed", "inner"),
        "wq": ("inner", "heads", "head_dim"),
        "wk": ("inner", "heads", "head_dim"),
        "wv": ("inner", "heads", "head_dim"),
        "w_igate": ("inner", None),
        "b_igate": (None,),
        "w_fgate": ("inner", None),
        "b_fgate": (None,),
        "out_norm": ("inner",),
        "down_proj": ("inner", "embed"),
    }
    return specs, axes


def _mlstm_chunk(state, q, k, v, i_raw, f_raw):
    """L steps of the reference's ``_mlstm_cell`` in closed form.

    state: C (B, H, hd, hd), n (B, H, hd), m (B, H); q (scaled), k, v:
    (B, H, L, hd); i_raw, f_raw: (B, H, L).  Unrolled, the cell's
    stabiliser ``m_t = max(log f_t + m_{t-1}, i_t)`` is ``F_t +
    max(m_0, max_{s<=t}(i_s − F_s))`` with F the cumulative log forget
    gate; step s enters C_t and n_t with weight ``exp(F_t − F_s + i_s −
    m_t)`` and the carried state with ``exp(F_t + m_0 − m_t)``, both at
    most 1; the denominator is the cell's ``max(|n_t·q_t|, exp(−m_t))``.
    Returns (the final (C, n, m), h (B, H, L, hd))."""
    C0, n0, m0 = state
    L = q.shape[2]
    F_ = torch.cumsum(F.logsigmoid(f_raw), dim=-1)
    m = F_ + torch.maximum(m0[..., None],
                           torch.cummax(i_raw - F_, dim=-1).values)
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    d = F_[..., :, None] - F_[..., None, :] + i_raw[..., None, :] \
        - m[..., :, None]
    w = torch.exp(torch.where(causal, d, float("-inf")))    # (B, H, L, L)
    e = torch.exp(F_ + m0[..., None] - m)                   # (B, H, L)
    a = w * (q @ k.transpose(-1, -2))
    num = a @ v + e[..., None] * (q @ C0)
    nq = a.sum(-1) + e * (q @ n0[..., None])[..., 0]
    den = torch.maximum(torch.abs(nq), torch.exp(-m))
    kw = k * w[..., -1, :, None]
    C = kw.transpose(-1, -2) @ v + e[..., -1, None, None] * C0
    n = kw.sum(-2) + e[..., -1, None] * n0
    return (C, n, m[..., -1]), num / den[..., None]


def _mlstm_project(p, xi):
    """xi: (B, S, I) f32 -> q (unscaled), k, v (B, H, S, hd) and the
    gates' inputs without their biases (B, H, S), f32; under tensor
    parallelism partial sums over this rank's rows of I."""
    return (torch.einsum("bsi,ihk->bhsk", xi, p["wq"].float()),
            torch.einsum("bsi,ihk->bhsk", xi, p["wk"].float()),
            torch.einsum("bsi,ihk->bhsk", xi, p["wv"].float()),
            torch.einsum("bsi,ih->bhs", xi, p["w_igate"].float()),
            torch.einsum("bsi,ih->bhs", xi, p["w_fgate"].float()))


def _mlstm_scan(p, xi, state=None, chunk: int = 1024, mesh=None):
    """xi: (B, S, d_inner) f32 -> (h (B, S, H·hd) f32, the final (C, n,
    m)).  ``state``: the (C, n, m) to start from (zeros).  The
    reference's time loop runs ``chunk`` steps at a time in closed form
    (``_mlstm_chunk``): the same stabiliser and denominator, the sums
    in another order; (B, H, chunk, chunk) weights a chunk.

    ``mesh`` (tensor parallelism): ``xi`` holds this rank's channels and
    ``p`` its rows of the projections; one reduce-scatter of the partial
    projections gives this rank's H/n heads, whose h is its channels."""
    b, s, _ = xi.shape
    hd = p["wq"].shape[-1]
    q, k, v, i_raw, f_raw = TP.scatter_sum(_mlstm_project(p, xi), 1, mesh)
    nh = q.shape[1]
    h0 = 0 if mesh is None else mesh.get_local_rank() * nh
    q = q * (1.0 / math.sqrt(hd))
    i_raw = i_raw + p["b_igate"][h0:h0 + nh].float()[:, None]
    f_raw = f_raw + p["b_fgate"][h0:h0 + nh].float()[:, None]
    if state is None:
        state = init_mlstm_state(b, nh * hd // MLSTM_EXPAND, nh,
                                 device=xi.device)
    hs = []
    for lo in range(0, s, chunk):
        hi = min(s, lo + chunk)
        state, h = _mlstm_chunk(state, q[:, :, lo:hi], k[:, :, lo:hi],
                                v[:, :, lo:hi], i_raw[..., lo:hi],
                                f_raw[..., lo:hi])
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2)
    return h.reshape(b, s, nh * hd), state


def _rms_norm(x, scale, mesh, eps: float = 1e-6):
    """``layers.rms_norm`` over a last dim whose chunks the 'model' ranks
    hold (``x`` and ``scale`` this rank's): the mean square of the whole
    row is the mean of the ranks' chunk means."""
    dt = x.dtype
    x = x.float()
    var = TP.model_mean(torch.mean(x * x, dim=-1, keepdim=True), mesh)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def _mlstm(p, x, state, chunk: int, mesh=None):
    """The mLSTM block -> (out, the final state); with ``mesh``, this
    rank's part on its chunks ``p`` (``mlstm_forward``): a partial
    output."""
    uz = torch.einsum("bsd,di->bsi", x, p["up_proj"].to(x.dtype))
    u, z = TP.split_pair(uz, mesh)
    h, new_state = _mlstm_scan(p, u.float(), state, chunk, mesh)
    h = _rms_norm(h, p["out_norm"], mesh)
    h = h * F.silu(z.float())
    out = torch.einsum("bsi,id->bsd", h.to(x.dtype),
                       p["down_proj"].to(x.dtype))
    return out, new_state


#: the mLSTM's leaves on 'model' (``TP_PRIORITY``: "inner" before
#: "heads"): the dim each is split on, None replicated
MLSTM_TP = {"up_proj": 1, "wq": 0, "wk": 0, "wv": 0, "w_igate": 0,
            "b_igate": None, "w_fgate": 0, "b_fgate": None, "out_norm": 0,
            "down_proj": 0}


def mlstm_forward(p, x, *, n_heads: int, state=None,
                  return_state: bool = False, chunk: int = 1024):
    """x: (B, S, D) -> (B, S, D) in x's dtype; with ``return_state`` also
    the final (C, n, m) f32 (the decode state).  ``chunk``: the steps
    the scan takes at once; the heads are the leaves' (``n_heads``).

    ``DTensor`` leaves on the 'model' mesh (laid out as ``MLSTM_TP``)
    run this rank's part on local tensors: ``up_proj``'s output gathered
    for this rank's channels of u and z (``models.tp.split_pair``), the
    projections' partial sums reduce-scattered to its heads, the norm's
    mean square over the whole row, ``down_proj``'s partial output
    summed in f32.  x is replicated over 'model' (its gradient comes
    back ``Partial``); the output is a replicated ``DTensor``."""
    if is_dtensor(p["wq"]):
        if state is not None or return_state:
            raise NotImplementedError(TP.SERVING)
        mesh, pl = TP.local_leaves(p, MLSTM_TP, "mLSTM")
        out, _ = _mlstm(pl, TP.tokens_local(x, mesh, True), None, chunk,
                        mesh)
        return TP.replicated_sum(out, mesh)
    out, new_state = _mlstm(p, x, state, chunk)
    if return_state:
        return out, new_state
    return out


def init_mlstm_state(batch: int, d_model: int, n_heads: int, *,
                     device="cuda"):
    """(C (B, H, hd, hd), n (B, H, hd), m (B, H)) f32 zeros, ``hd =
    2·d_model / H``: the O(1) decode state."""
    hd = MLSTM_EXPAND * d_model // n_heads
    return (torch.zeros((batch, n_heads, hd, hd), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, n_heads, hd), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, n_heads), dtype=torch.float32,
                        device=device))


def mlstm_state_axes():
    return (("cache_batch", None, "head_dim", None),
            ("cache_batch", None, "head_dim"),
            ("cache_batch", None))


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


def _tie_half(x, y):
    """d max(x, y) / dx: 1 where x > y, 0 where x < y, 1/2 at a tie (as
    ``jnp.maximum`` splits a tie's gradient)."""
    return torch.sign(x - y).add_(1.0).mul_(0.5)


class _SLSTMScan(torch.autograd.Function):
    """The reference's ``_slstm_cell`` over S steps, with its backward
    written out: the recurrence issues ~17 kernels a step forward and
    ~40 backward, where autograd's graph of the cell takes several
    times that.

    Layouts (f32): gx (S, H, B, 4, hd), the input projections of the
    gates i, f, z, o per step; R (H, hd, 4·hd), ``r_gates`` per head
    (``rec = h @ R``); the state c, n, m, h each (H, B, hd).  Returns
    h per step (S, H, B, hd) and the final c, n, m, h.  Ties in
    ``max(log f + m, i)`` and ``max(n, 1)`` split the gradient
    evenly."""

    @staticmethod
    def forward(ctx, gx, R, c0, n0, m0, h0):
        s, nh, b, _, hd = gx.shape
        st = torch.empty((4, s + 1, nh, b, hd), dtype=gx.dtype,
                         device=gx.device)
        cs, ns, ms, hs = st
        cs[0], ns[0], ms[0], hs[0] = c0, n0, m0, h0
        pre = torch.empty_like(gx)
        # per step: f_g, i_g, z, o (the backward's factors)
        fizo = torch.empty((4, s, nh, b, hd), dtype=gx.dtype,
                           device=gx.device)
        for t in range(s):
            torch.add(gx[t], torch.bmm(hs[t], R).view(nh, b, 4, hd),
                      out=pre[t])
            gi, gf, gz, go = pre[t].unbind(2)
            a = F.logsigmoid(gf).add_(ms[t])
            torch.maximum(a, gi, out=ms[t + 1])
            fg, ig, z, o = fizo[:, t]
            torch.exp(gi - ms[t + 1], out=ig)
            torch.exp(a.sub_(ms[t + 1]), out=fg)
            torch.tanh(gz, out=z)
            torch.sigmoid(go, out=o)
            torch.add(fg * cs[t], ig * z, out=cs[t + 1])
            torch.add(fg * ns[t], ig, out=ns[t + 1])
            torch.div(o * cs[t + 1], torch.clamp_min(ns[t + 1], 1.0),
                      out=hs[t + 1])
        ctx.save_for_backward(R, pre, st, fizo)
        return hs[1:], cs[s], ns[s], ms[s], hs[s]

    @staticmethod
    def backward(ctx, d_hs, dc, dn, dm, dh):
        R, pre, st, fizo = ctx.saved_tensors
        s, nh, b, _, hd = pre.shape
        cs, ns, ms, hs = st

        def zero_if_none(g):
            return torch.zeros_like(cs[0]) if g is None else g.clone()

        dc, dn, dm, dh = map(zero_if_none, (dc, dn, dm, dh))
        dpre = torch.empty_like(pre)
        rt = R.transpose(1, 2)
        for t in reversed(range(s)):
            if d_hs is not None:
                dh = dh + d_hs[t]
            gi, gf, gz, go = pre[t].unbind(2)
            fg, ig, z, o = fizo[:, t]
            dgi, dgf, dgz, dgo = dpre[t].unbind(2)
            c, n = cs[t + 1], ns[t + 1]
            # h = o·c / max(n, 1)
            q = dh / torch.clamp_min(n, 1.0)
            dc = dc + q * o
            dn = dn - q * hs[t + 1] * _tie_half(n, 1.0)
            torch.mul(q * c, o * (1.0 - o), out=dgo)
            # c = f_g·c' + i_g·z, n = f_g·n' + i_g
            dfg = (dc * cs[t] + dn * ns[t]) * fg
            dig = (dc * z + dn) * ig
            torch.mul(dc * ig, 1.0 - z * z, out=dgz)
            dc, dn = dc * fg, dn * fg
            # i_g = exp(i − m), f_g = exp(a − m), m = max(a, i),
            # a = log f + m'
            dm = dm - dfg - dig
            a = F.logsigmoid(gf).add_(ms[t])
            wa = _tie_half(a, gi)
            da = dfg + dm * wa
            torch.add(dig, dm * (1.0 - wa), out=dgi)
            torch.mul(da, torch.sigmoid(-gf), out=dgf)
            dm = da
            dh = torch.bmm(dpre[t].view(nh, b, 4 * hd), rt)
        d_r = torch.einsum("shbk,shbx->hkx", hs[:-1],
                           dpre.view(s, nh, b, 4 * hd))
        return dpre, d_r, dc, dn, dm, dh


def _slstm_scan(p, x, state=None):
    """x: (B, S, D) -> (h (B, S, H·hd) f32, the final (c, n, m, h)), H
    and hd the leaves' (under tensor parallelism this rank's heads).
    ``state``: the (c, n, m, h) to start from (zeros by default)."""
    b, s, _ = x.shape
    _, _, nh, hd = p["w_gates"].shape
    gx = torch.einsum("bsd,gdhk->shbgk", x.float(), p["w_gates"].float()) \
        + p["b_gates"].float().transpose(0, 1)[None, :, None]
    if state is None:
        # the stabiliser m starts at 0, as c, n and h
        state = init_slstm_state(b, nh * hd, nh, device=x.device)
    r = p["r_gates"].float()
    R = r.permute(1, 2, 0, 3).reshape(nh, hd, 4 * hd)
    hs, *final = _SLSTMScan.apply(gx.contiguous(), R,
                                  *(v.transpose(0, 1) for v in state))
    h = hs.permute(2, 0, 1, 3).reshape(b, s, nh * hd)
    return h, tuple(v.transpose(0, 1) for v in final)


def _slstm(p, x, state, mesh=None):
    """The sLSTM block -> (out, the final state); with ``mesh``, this
    rank's part on its chunks ``p`` (``slstm_forward``): a partial
    output."""
    h, new_state = _slstm_scan(p, x, state)
    h = L.rms_norm(TP.gather_last(h, mesh), p["out_norm"])
    uz = torch.einsum("bsd,du->bsu", h.to(x.dtype), p["up_proj"].to(x.dtype))
    u, z = TP.split_pair(uz, mesh)
    out = torch.einsum("bsu,ud->bsd",
                       L.ACTIVATIONS["gelu"](u) * torch.sigmoid(z),
                       p["down_proj"].to(x.dtype))
    return out, new_state


#: the sLSTM's leaves on 'model' (``TP_PRIORITY``: "ffn" for the up and
#: down projections, "heads" for the gates): the dim each is split on,
#: None replicated
SLSTM_TP = {"w_gates": 2, "b_gates": 1, "r_gates": 1, "out_norm": None,
            "up_proj": 1, "down_proj": 0}


def slstm_forward(p, x, *, n_heads: int, state=None,
                  return_state: bool = False):
    """x: (B, S, D) -> (B, S, D) in x's dtype; with ``return_state`` also
    the final (c, n, m, h), each (B, H, hd) f32 (the decode state).  The
    heads are the leaves' (``n_heads``).

    ``DTensor`` leaves on the 'model' mesh (laid out as ``SLSTM_TP``)
    run this rank's part on local tensors: its heads' recurrence
    (``_SLSTMScan`` unchanged), h gathered over 'model' for ``out_norm``,
    ``up_proj``'s output gathered for this rank's chunks of u and z,
    ``down_proj``'s partial output summed in f32.  x is replicated over
    'model' (its gradient comes back ``Partial``); the output is a
    replicated ``DTensor``.  Training only."""
    if is_dtensor(p["w_gates"]):
        if state is not None or return_state:
            raise NotImplementedError(TP.SERVING)
        mesh, pl = TP.local_leaves(p, SLSTM_TP, "sLSTM")
        out, _ = _slstm(pl, TP.tokens_local(x, mesh, True), None, mesh)
        return TP.replicated_sum(out, mesh)
    out, new_state = _slstm(p, x, state)
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
