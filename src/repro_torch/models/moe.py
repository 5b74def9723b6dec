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

Tensor parallelism.  On a mesh with a 'model' axis the leaves are
``DTensor``s over it (``sharding.dtensor``), laid out by the reference's
rules in one of two ways, and ``moe_forward_auto`` runs each rank's
part on local tensors (DTensor has no sharding rule for the dispatch's
sort, search and gathers):

  * the F layout (``TP_PRIORITY``, Granite): ``w_up``/``w_gate`` split
    on F, ``w_down`` on its F dim; each rank runs every expert on its F
    chunk, and ``w_down``'s contraction gives a partial (slots, D);
  * the E layout (``TP_PRIORITY_EXPERTS``, OLMoE; ``moe_forward_ep``):
    every expert leaf split on E; rank r of n owns experts
    ``r·E/n … (r+1)·E/n − 1`` and keeps only their slots (the
    reference's ``moe_forward_ep`` body: positions and capacity over all
    E, the other ranks' slots at zero weight).

The router, the positions and the dispatch run on every rank's copy of
the replicated tokens, the same on each (the dispatch is deterministic).
Each rank's partial (G, T, D) output, in f32, is summed over 'model'
once (:func:`_model_sum`), then cast.  Gradients: the combine path
gives each rank its share of x's and the router's gradient, so both
local views declare a ``Partial`` gradient (summed over 'model' by the
step's reduction); every rank computes the aux loss in full, so its
gradient enters at 1/n a rank (:func:`_aux_share`) and is counted once;
each expert leaf's chunk gets its own gradient.  The result equals the
unsharded ``moe_forward_grouped``'s up to reduction order, and on a
'model' axis of one rank its bits.

Token groups across ranks.  Under ``lags_hier`` the reference dispatches
each pod's slice of the batch in pods·data groups, or as ONE group when
they do not divide it (``launch.train.pod_auto_moe_groups``), and that
group spans the pod's 'data' ranks.  ``groups=TokenSpan(...)`` runs it
(:func:`_span_forward`): the rows of every rank of the pod's 'data'
group are gathered (``tp.gather_rows``, data rank-major: the slice's
order), the whole group is dispatched with its own capacity, and each
rank keeps its own rows.  The gather's backward reduce-scatters: a
token's output depends on the others only through the capacity drops,
which are discrete, so the other rows' share of the combine's gradient
is zero, and the aux loss's reaches every row.  Every rank computes the
group's aux loss in full; the step takes the mean of the pod's ranks'
gradients (and losses), so it counts once.  Data-only meshes only: on
a 'model' axis the step refuses the span (``launch.train``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import layers as L
from repro_torch.models import tp as TP
from repro_torch.sharding.dtensor import is_dtensor


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
    e = p["router"].shape[-1]
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


def _grouped_sum(p, xt, *, top_k: int, act, capacity: int,
                 experts: tuple | None = None):
    """Dispatch over ``G`` groups of tokens ``xt`` (G, T, D), each with
    its own ``capacity`` per expert -> (the combined output in f32
    (G, T, D), aux per group (G,)).  ``experts`` (lo, n): ``p``'s expert
    leaves hold experts ``lo … lo + n − 1`` only, and only their slots
    are dispatched (the E layout); positions and capacity count every
    expert, as the unsharded dispatch does."""
    g, t, d = xt.shape
    e = p["router"].shape[-1]
    lo, n_e = (0, e) if experts is None else experts
    dev = xt.device
    gate_vals, expert_idx, aux = _route(p, xt, top_k)
    n = t * top_k
    flat_expert = expert_idx.reshape(g, n)
    position, keep = _positions(flat_expert, e, capacity)
    if experts is not None:
        keep = keep & (flat_expert >= lo) & (flat_expert < lo + n_e)
    gates_flat = gate_vals.reshape(g * n, 1) * keep.reshape(g * n, 1)
    slots = g * n_e * capacity
    # the buffer row of each (token, k), or the zero row when it drops;
    # and the (token, k) row of each buffer slot, or the zero row
    base = torch.arange(g, device=dev)[:, None] * (n_e * capacity)
    dst = torch.where(keep, base + (flat_expert - lo) * capacity + position,
                      slots).reshape(-1)
    src = torch.full((slots + 1,), g * n, device=dev).scatter_(
        0, dst, torch.arange(g * n, device=dev))[:slots]
    x_rep = xt[:, :, None].expand(g, t, top_k, d).reshape(g * n, d)
    buf = _TakeRows.apply(x_rep, src, dst).view(g, n_e, capacity, d)
    out_buf = _expert_ffn(p, buf, act, xt.dtype).reshape(slots, d)
    gathered = _TakeRows.apply(out_buf, dst, src)             # (G·N, D)
    weighted = gathered.float() * gates_flat
    return weighted.view(g, t, top_k, d).sum(2), aux


def _grouped_core(p, xt, *, top_k: int, act, capacity: int):
    """:func:`_grouped_sum` over all experts, cast to the tokens' dtype
    -> ((G, T, D), aux per group (G,))."""
    out, aux = _grouped_sum(p, xt, top_k=top_k, act=act, capacity=capacity)
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


#: the F dim of each expert leaf: what the F layout splits
_FFN_DIM = {"w_up": 2, "w_gate": 2, "w_down": 1}


def tp_layout(p) -> str:
    """The tensor-parallel layout of an MoE layer's ``DTensor`` leaves on
    a 1-D 'model' mesh: ``"experts"`` (every expert leaf ``Shard(0)``),
    ``"ffn"`` (``w_up``/``w_gate`` ``Shard(2)``, ``w_down`` ``Shard(1)``;
    also every leaf whole on a mesh of one rank, where both layouts are
    the whole layer), or ``"replicated"`` (every leaf whole on several
    ranks).  Anything else raises."""
    from torch.distributed.tensor import Shard
    mesh = p["router"].device_mesh
    if mesh.ndim != 1:
        raise ValueError(f"MoE leaves on a {mesh.ndim}-D mesh: tensor "
                         f"parallelism lays them over one 'model' axis")
    place = {k: tuple(v.placements) for k, v in p.items()}
    experts = [k for k in place if k != "router"]
    if place["router"][0].is_replicate():
        if all(pl[0].is_replicate() for pl in place.values()):
            return "ffn" if mesh.size() == 1 else "replicated"
        if all(place[k] == (Shard(0),) for k in experts):
            return "experts"
        if all(place[k] == (Shard(_FFN_DIM[k]),) for k in experts):
            return "ffn"
    raise NotImplementedError(f"MoE leaves laid out as {place} over "
                              f"'model': neither the F nor the E layout")


#: the sum over 'model' and the tokens' local view (``models.tp``), by
#: these names so that a fault can be planted in this layer alone
_model_sum = TP.model_sum
_tokens_local = TP.tokens_local


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose gradient is scaled by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def _aux_share(aux, mesh):
    """The aux loss, computed in full on every 'model' rank, with its
    gradient divided among them: summed over 'model' with the combine
    path's shares, it counts once."""
    return _ScaleGrad.apply(aux, 1.0 / mesh.size())


def _tp_forward(p, x, *, top_k: int, activation: str,
                capacity_factor: float, groups: int,
                layout: str | None = None):
    """``moe_forward_grouped`` on ``DTensor`` leaves over a 1-D 'model'
    mesh, each rank running its part of the experts on local tensors
    (module docstring) -> (out, aux), ``DTensor``s replicated over
    'model'.  ``layout``: ``tp_layout(p)`` unless given."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = p["router"].device_mesh
    layout = layout or tp_layout(p)
    partial = layout != "replicated"
    n = mesh.size()
    xl = _tokens_local(x, mesh, partial)
    pl = {k: v.to_local(grad_placements=(Partial(),) * mesh.ndim)
          if k == "router" and partial else v.to_local()
          for k, v in p.items()}
    b, s, d = xl.shape
    g = groups if groups > 1 and b % groups == 0 else 1
    tg = (b // g) * s
    e = pl["router"].shape[-1]
    experts = None
    if layout == "experts":
        experts = (mesh.get_local_rank() * (e // n), e // n)
    out, aux = _grouped_sum(pl, xl.reshape(g, tg, d), top_k=top_k,
                            act=L.ACTIVATIONS[activation],
                            capacity=_capacity(capacity_factor, tg, top_k, e),
                            experts=experts)
    if partial:
        out = _model_sum(out, mesh)
        aux = _aux_share(aux, mesh)
    out = out.to(xl.dtype).reshape(b, s, d)
    aux = aux.mean() if g > 1 else aux[0]
    whole = (Replicate(),) * mesh.ndim
    return (DTensor.from_local(out, mesh, whole, run_check=False),
            DTensor.from_local(aux, mesh, whole, run_check=False))


def moe_forward_ep(p, x, *, top_k: int, activation: str = "silu",
                   capacity_factor: float = 1.25, axis: str = "model"):
    """Expert parallelism, the reference's ``moe_forward_ep``: the leaves
    are ``DTensor``s on the 1-D mesh of ``axis``, every expert leaf split
    on E (the router whole); ``x`` is replicated over it (a ``DTensor``,
    or a plain tensor the same on every rank).  Each rank routes every
    token, keeps the slots of its own experts and runs them; one sum
    over ``axis`` combines.  One dispatch over all B·S tokens (capacity
    over all E) -> (out, aux), ``DTensor``s replicated over ``axis``.
    The training path reaches the same code through
    ``moe_forward_auto``, which reads the layout off the leaves."""
    router = p.get("router")
    mesh = router.device_mesh if is_dtensor(router) else None
    if mesh is None or tuple(mesh.mesh_dim_names or ()) != (axis,) or (
            mesh.size() > 1 and tp_layout(p) != "experts"):
        raise ValueError(f"moe_forward_ep takes DTensor leaves on the "
                         f"{axis!r} mesh, every expert leaf split on E")
    return _tp_forward(p, x, top_k=top_k, activation=activation,
                       capacity_factor=capacity_factor, groups=1,
                       layout="experts")


@dataclasses.dataclass(frozen=True)
class TokenSpan:
    """One MoE token group made of the rows of every rank of ``group``
    (``size`` ranks; this one is ``rank`` of them): what
    ``moe_forward_auto(groups=)`` takes for a group across ranks."""
    group: object
    size: int
    rank: int


def _span_forward(p, x, span: TokenSpan, **kw):
    """The rows ``x`` (b, S, D) of every rank of ``span`` dispatched as
    one group, this rank's b rows of the output kept -> (out, aux)."""
    b = x.shape[0]
    out, aux = moe_forward_grouped(
        p, TP.gather_rows(x, span.group, span.size), groups=1, **kw)
    return out.narrow(0, span.rank * b, b), aux


def moe_forward_auto(p, x, *, top_k: int, activation: str = "silu",
                     capacity_factor: float = 1.25,
                     groups: int | TokenSpan = 1):
    """The dispatch the model runs.  The reference groups tokens by the
    mesh's auto-partitioned data axes.  In its data-manual steps
    (``lags_dp`` and the rest) those axes are manual, so each worker
    dispatches its own tokens as one group, as every rank of the port
    does by default.  Under its ``pod_auto`` step (``lags_hier``) a
    rank's rows hold several of the reference's groups: the step passes
    their number (``launch.train.pod_auto_moe_groups``), or a
    :class:`TokenSpan` when the rows of several ranks make one group
    (module docstring).  ``DTensor`` leaves over 'model' run each rank's
    part of the experts (:func:`_tp_forward`, in the layout the leaves
    carry)."""
    if isinstance(groups, TokenSpan):
        if is_dtensor(p["router"]):
            raise NotImplementedError(
                "an MoE token group across ranks on DTensor leaves over "
                "'model' (ROADMAP.md queue 1 item 7e's third part, the "
                "tensor-parallel part on a 'model' axis)")
        return _span_forward(p, x, groups, top_k=top_k,
                             activation=activation,
                             capacity_factor=capacity_factor)
    if is_dtensor(p["router"]):
        return _tp_forward(p, x, top_k=top_k, activation=activation,
                           capacity_factor=capacity_factor, groups=groups)
    return moe_forward_grouped(p, x, top_k=top_k, activation=activation,
                               capacity_factor=capacity_factor,
                               groups=groups)
