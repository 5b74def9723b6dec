"""The Mixture-of-Experts layer of ``repro.models.moe``: a top-k router
and capacity-bounded dispatch into an (E, C, D) buffer.

  1. router logits (T, E) in f32 -> the top-k experts of each token
     (largest first, ties to the lowest index, as ``jax.lax.top_k``),
     their probabilities renormalised over the k picked;
  2. each (token, k) pair's slot within its expert: a stable sort of the
     flat assignment by expert; pairs past ``capacity`` drop (their
     combine weight is zero, the residual connection carries them);
  3. the kept pairs' tokens go into the (E, C, D) buffer, the expert
     FFNs run as batched products over the expert axis, and each token
     sums its k weighted outputs.

Determinism.  The reference scatters with ``.at[...].add``; on a card
that would be ``index_add_``, whose colliding rows meet in atomics in no
fixed order.  Here a kept pair owns exactly one slot, so the dispatch
and the combine are row gathers both ways (:class:`_TakeRows`: the
backward of each gather is the gather by the inverse map), the copy of
a token to its k pairs is an ``expand`` (its backward a sum over k), and
the combine a (T, K, D) sum over k.  Forward and backward give the same
bits on every run, with or without deterministic algorithms.

Leaves: ``router`` (D, E), ``w_up`` and ``w_gate`` (E, D, F), ``w_down``
(E, F, D), with the logical axes ``("embed", None)`` and
``("experts", "embed", "expert_ffn")`` / ``("experts", "expert_ffn",
"embed")``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L


def moe_specs(d_model: int, d_ff: int, n_experts: int,
              gated: bool = True) -> tuple[dict, dict]:
    """(leaf specs as (shape, init), logical axes) of one MoE FFN:
    ``init_moe``'s shapes and scales."""
    s_in, s_out = 1 / math.sqrt(d_model), 1 / math.sqrt(d_ff)
    specs = {"router": ((d_model, n_experts), s_in),
             "w_up": ((n_experts, d_model, d_ff), s_in),
             "w_down": ((n_experts, d_ff, d_model), s_out)}
    axes = {"router": ("embed", None),
            "w_up": ("experts", "embed", "expert_ffn"),
            "w_down": ("experts", "expert_ffn", "embed")}
    if gated:
        specs["w_gate"] = ((n_experts, d_model, d_ff), s_in)
        axes["w_gate"] = ("experts", "embed", "expert_ffn")
    return specs, axes


def _padded(x):
    """``x`` (N, D) with a zero row appended (row N)."""
    return torch.cat([x, x.new_zeros(1, x.shape[1])])


class _TakeRows(torch.autograd.Function):
    """``_padded(x)[take]``: rows of ``x``, or zeros where ``take`` is
    ``len(x)``.  ``back`` is the inverse map (row i of ``x`` went to
    output row ``back[i]``, or nowhere when ``back[i]`` is the output's
    length): no row of ``x`` is taken twice, so the gradient is
    ``_padded(grad)[back]``, a gather, not a scatter-add."""

    @staticmethod
    def forward(ctx, x, take, back):
        ctx.save_for_backward(back)
        return _padded(x).index_select(0, take)

    @staticmethod
    def backward(ctx, grad):
        (back,) = ctx.saved_tensors
        return _padded(grad).index_select(0, back), None, None


def _route(p, xt, top_k: int):
    """Router over tokens ``xt`` (..., T, D) -> (gate_vals (..., T, K),
    expert_idx (..., T, K), aux (...)): the Switch load-balance loss
    ``E · sum_e f_e · p_e`` per leading index."""
    t = xt.shape[-2]
    e = p["w_up"].shape[0]
    logits = torch.einsum("...td,de->...te", xt.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k's picks: largest first, ties to the lowest index
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., :top_k], order[..., :top_k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)
    me = probs.mean(-2)                                          # (..., E)
    flat = expert_idx.reshape(expert_idx.shape[:-2] + (-1,))
    ce = torch.zeros_like(me).scatter_add_(
        -1, flat, torch.full(flat.shape, 1.0 / (t * top_k),
                             device=me.device))
    return gate_vals, expert_idx, e * (me * ce).sum(-1)


def _positions(flat_expert, e: int, capacity: int):
    """Slot position of each (token, k) within its expert's segment, in
    assignment order, over the last dim of ``flat_expert`` (..., N);
    ``keep`` marks the pairs under ``capacity``."""
    n = flat_expert.shape[-1]
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_experts = torch.gather(flat_expert, -1, order)
    experts = torch.arange(e, device=flat_expert.device).expand(
        flat_expert.shape[:-1] + (e,)).contiguous()
    seg_start = torch.searchsorted(sorted_experts, experts, side="left")
    pos_sorted = torch.arange(n, device=flat_expert.device) \
        - torch.gather(seg_start, -1, sorted_experts)
    position = torch.empty_like(order).scatter_(-1, order, pos_sorted)
    return position, position < capacity


def _expert_ffn(p, buf, act, dtype):
    """``buf`` (..., E, C, D) through each expert's FFN, in ``dtype``."""
    up = torch.einsum("...ecd,edf->...ecf", buf, p["w_up"].to(dtype))
    if "w_gate" in p:
        gate = torch.einsum("...ecd,edf->...ecf", buf, p["w_gate"].to(dtype))
        h = act(gate) * up
    else:
        h = act(up)
    return torch.einsum("...ecf,efd->...ecd", h, p["w_down"].to(dtype))


def _grouped_core(p, xt, *, top_k: int, act, capacity: int):
    """Dispatch over ``G`` groups of tokens ``xt`` (G, T, D), each with
    its own ``capacity`` per expert -> ((G, T, D), aux per group (G,))."""
    g, t, d = xt.shape
    e = p["w_up"].shape[0]
    dev = xt.device
    gate_vals, expert_idx, aux = _route(p, xt, top_k)
    n = t * top_k
    flat_expert = expert_idx.reshape(g, n)
    position, keep = _positions(flat_expert, e, capacity)
    gates_flat = gate_vals.reshape(g * n, 1) * keep.reshape(g * n, 1)
    slots = g * e * capacity
    # the buffer row of each (token, k), or the zero row when it drops;
    # and the (token, k) row of each buffer slot, or the zero row
    base = torch.arange(g, device=dev)[:, None] * (e * capacity)
    dst = torch.where(keep, base + flat_expert * capacity + position,
                      slots).reshape(-1)
    src = torch.full((slots + 1,), g * n, device=dev).scatter_(
        0, dst, torch.arange(g * n, device=dev))[:slots]
    x_rep = xt[:, :, None].expand(g, t, top_k, d).reshape(g * n, d)
    buf = _TakeRows.apply(x_rep, src, dst).view(g, e, capacity, d)
    out_buf = _expert_ffn(p, buf, act, xt.dtype).reshape(slots, d)
    gathered = _TakeRows.apply(out_buf, dst, src)             # (G·N, D)
    weighted = gathered.float() * gates_flat
    out = weighted.view(g, t, top_k, d).sum(2)
    return out.to(xt.dtype), aux


def _dense_core(p, xt, *, top_k: int, act, capacity: int):
    """Dispatch over flat tokens ``xt`` (T, D) -> ((T, D), aux)."""
    out, aux = _grouped_core(p, xt[None], top_k=top_k, act=act,
                             capacity=capacity)
    return out[0], aux[0]


def _capacity(capacity_factor: float, t: int, top_k: int, e: int) -> int:
    return max(1, int(capacity_factor * t * top_k / e))


def moe_forward(p, x, *, top_k: int, activation: str = "silu",
                capacity_factor: float = 1.25):
    """x (B, S, D) -> ((B, S, D), aux load-balance loss): one dispatch
    over all B·S tokens."""
    b, s, d = x.shape
    t = b * s
    e = p["w_up"].shape[0]
    out, aux = _dense_core(p, x.reshape(t, d), top_k=top_k,
                           act=L.ACTIVATIONS[activation],
                           capacity=_capacity(capacity_factor, t, top_k, e))
    return out.reshape(b, s, d), aux


def moe_forward_grouped(p, x, *, top_k: int, activation: str = "silu",
                        capacity_factor: float = 1.25, groups: int = 1):
    """Tokens split into ``groups`` along the batch dim, each group
    dispatched with its own capacity (GShard/Switch semantics); the
    reference's sharding pins have no counterpart on one device.  A
    batch that ``groups`` does not divide runs as one group."""
    b, s, d = x.shape
    if groups <= 1 or b % groups:
        return moe_forward(p, x, top_k=top_k, activation=activation,
                           capacity_factor=capacity_factor)
    e = p["w_up"].shape[0]
    tg = (b // groups) * s
    out, aux = _grouped_core(p, x.reshape(groups, tg, d), top_k=top_k,
                             act=L.ACTIVATIONS[activation],
                             capacity=_capacity(capacity_factor, tg, top_k,
                                                e))
    return out.reshape(b, s, d), aux.mean()


def moe_forward_ep(p, x, *, top_k: int, activation: str = "silu",
                   capacity_factor: float = 1.25, axis: str = "model"):
    """Expert parallelism shards the experts over a ``model`` axis."""
    raise NotImplementedError(
        "expert-parallel MoE needs a model axis > 1: tensor parallelism "
        "is not ported yet (ROADMAP.md queue 1 item 7, its tensor-parallel "
        "tail)")


def moe_forward_auto(p, x, *, top_k: int, activation: str = "silu",
                     capacity_factor: float = 1.25, groups: int = 1):
    """The dispatch the model runs.  The reference groups tokens by the
    mesh's auto-partitioned data axes.  In its data-manual steps
    (``lags_dp`` and the rest) those axes are manual, so each worker
    dispatches its own tokens as one group, as every rank of the port
    does by default.  Under its ``pod_auto`` step (``lags_hier``) a
    rank's rows hold several of the reference's groups: the step passes
    their number (``launch.train.pod_auto_moe_groups``)."""
    return moe_forward_grouped(p, x, top_k=top_k, activation=activation,
                               capacity_factor=capacity_factor,
                               groups=groups)
