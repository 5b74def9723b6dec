"""The serving path of ``repro.serving.engine``: prefill (build the
caches) and one-token decode.

Sliding-window attention layers keep ring caches of the window's size;
xLSTM and Mamba layers carry their O(1) state.  The states mirror the
parameter layout: ``{"blocks": [one stack per period position, leading
n_periods axis], "tail": [one state per tail layer]}``, an attention
layer's state ``{"self": {"k", "v"}}`` (B, capacity, KV, hd), an mLSTM
layer's (C (B, H, hd, hd), n (B, H, hd), m (B, H)) f32, an sLSTM
layer's a 4-tuple of (B, H, hd) f32 and a Mamba layer's ``{"conv",
"ssm"}``: its conv's input tail (B, 3, d_inner) in the cache dtype and
its SSM state (B, d_inner, 16) f32.  An encoder-decoder's decoder
layers hold ``cross`` as well: the keys and values (B, Sm, KV, hd) of
the encoder's output, which :func:`prefill` fills and decode attends
over whole (every slot, unmasked, as the reference's decode does).

The reference scans over the stacked periods; here a loop over them
indexes the stacks (as ``models.transformer.forward`` does).
:func:`serve_step` writes the new token into the caches and states IN
PLACE (the reference's decode step donates them) and returns the same
tree.  Everything runs under ``torch.no_grad``.  An MoE feed-forward
serves drop-free (capacity for every token in flight), in prefill and
in decode alike.

Under tensor parallelism (``launch.serve``: the parameters ``DTensor``s
over 'model') prefill hands back the attention caches, self and cross,
whole (every head, every slot) as plain tensors, and the recurrent
states as this rank's chunks (``DTensor``s split on Mamba's ``d_inner``
or the xLSTM's heads; :func:`states_axes` ``by_heads``);
:func:`pad_states_for_decode` pads the self caches alone, and decode
runs each layer on the states ``launch.serve.place_states`` lays out
(cross-attention: ``attention.cross_decode``).  ``fetch`` (FSDP
serving) maps each layer's parameters to those it runs on just before
the layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F_

from repro_torch import tree
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.sharding import dtensor as D


def _attn_capacity(spec: T.BlockSpec, capacity: int) -> int:
    if spec.window:
        return min(capacity, spec.window)
    return capacity


def init_layer_state(cfg, spec: T.BlockSpec, batch: int, capacity: int,
                     dtype: torch.dtype, *, enc_len: int = 0, device="cuda"):
    """One layer's zero decode state (attention caches in ``dtype``; a
    cross-attention layer's ``cross`` cache of ``max(enc_len, 1)``
    slots)."""
    if spec.kind == "attn":
        st = {"self": A.init_cache(batch, _attn_capacity(spec, capacity),
                                   cfg.n_kv_heads, cfg.hd, dtype, device)}
        if spec.cross_attn:
            st["cross"] = A.init_cache(batch, max(enc_len, 1),
                                       cfg.n_kv_heads, cfg.hd, dtype, device)
        return st
    if spec.kind == "mamba":
        return S.init_mamba_state(batch, cfg.d_model, dtype, device=device)
    if spec.kind == "mlstm":
        return X.init_mlstm_state(batch, cfg.d_model, cfg.n_heads,
                                  device=device)
    if spec.kind == "slstm":
        return X.init_slstm_state(batch, cfg.d_model, cfg.n_heads,
                                  device=device)
    raise ValueError(spec.kind)


def _layout(cfg) -> tuple[list, int, int]:
    specs = T.build_blockspecs(cfg)
    per = T.find_period(specs)
    return specs, per, len(specs) // per


def init_states(cfg, batch: int, capacity: int, dtype: torch.dtype, *,
                enc_len: int = 0, device="cuda"):
    """Stacked per-period zero states mirroring the params layout
    (``enc_len``: the encoder output's length, for the cross caches)."""
    specs, per, n_periods = _layout(cfg)
    kw = dict(enc_len=enc_len, device=device)

    def stacked(j):
        one = init_layer_state(cfg, specs[j], batch, capacity, dtype, **kw)
        return tree.map(lambda x: x.expand((n_periods,) + x.shape).clone(),
                        one)

    return {"blocks": [stacked(j) for j in range(per)],
            "tail": [init_layer_state(cfg, specs[i], batch, capacity, dtype,
                                      **kw)
                     for i in range(n_periods * per, len(specs))]}


def layer_state_axes(cfg, spec: T.BlockSpec, by_heads: bool = False):
    """One layer's state axes (``by_heads``: the xLSTM states by their
    heads, the tensor-parallel serving layout; ``xlstm.mlstm_state_axes``)."""
    if spec.kind == "attn":
        ax = {"self": A.cache_axes()}
        if spec.cross_attn:
            ax["cross"] = A.cache_axes()
        return ax
    if spec.kind == "mamba":
        return S.mamba_state_axes()
    if spec.kind == "mlstm":
        return X.mlstm_state_axes(by_heads)
    if spec.kind == "slstm":
        return X.slstm_state_axes(by_heads)
    raise ValueError(spec.kind)


def states_axes(cfg, by_heads: bool = False):
    """Logical-axis tree mirroring :func:`init_states`' structure
    (``by_heads``: see :func:`layer_state_axes`)."""
    specs, per, n_periods = _layout(cfg)

    def stacked(j):
        return T._map_axes(lambda a: ("layers",) + a,
                           layer_state_axes(cfg, specs[j], by_heads))

    return {"blocks": [stacked(j) for j in range(per)],
            "tail": [layer_state_axes(cfg, specs[i], by_heads)
                     for i in range(n_periods * per, len(specs))]}


def _fit_cache_time(x, cap: int, prompt_len: int, ring: bool):
    """One prefill cache leaf on the decode slot layout.

    The time axis is ``-3``: ``(B, S, KV, hd)`` per layer, with a leading
    n_periods dim under the stacked ``blocks`` layout.  Decode writes
    token ``pos`` at slot ``pos % cap`` (ring) or ``min(pos, cap - 1)``
    (full), so a prefill cache holding the tokens in order is zero-padded
    at the end (prompt shorter than the cache) or rotated so token ``j``
    lands at slot ``j % cap`` (a full ring)."""
    axis = x.ndim - 3
    s = x.shape[axis]
    if s > cap:
        if not ring:
            raise ValueError(f"prompt of {prompt_len} tokens cannot hand "
                             f"off to a full cache of capacity {cap}")
        x = x.narrow(axis, s - cap, cap)
        s = cap
    if s < cap:
        return F_.pad(x, (0, 0) * (x.ndim - 1 - axis) + (0, cap - s))
    if ring:
        return torch.roll(x, prompt_len % cap, dims=axis)
    return x


def pad_states_for_decode(cfg, states, prompt_len: int, capacity: int):
    """Grow :func:`prefill`'s caches to the :func:`init_states` decode
    layout, so a prompt is processed once (no token-by-token replay):
    self-attention caches sized to the prompt (ring-truncated to the
    window for windowed layers) become capacity-sized caches with each
    token at its decode slot; xLSTM and Mamba states and cross caches
    pass through unchanged (under tensor parallelism the recurrent
    states as this rank's ``DTensor`` chunks, the cross caches whole).
    A VLM's ``prompt_len`` counts its patches too."""
    specs, per, n_periods = _layout(cfg)

    def fix(spec: T.BlockSpec, st):
        if spec.kind != "attn":
            return st
        cap = _attn_capacity(spec, capacity)
        out = dict(st)
        out["self"] = {k: _fit_cache_time(v, cap, prompt_len,
                                          ring=bool(spec.window))
                       for k, v in st["self"].items()}
        return out

    return {"blocks": [fix(specs[j], st)
                       for j, st in enumerate(states["blocks"])],
            "tail": [fix(specs[n_periods * per + i], st)
                     for i, st in enumerate(states["tail"])]}


# ---------------------------------------------------------------------------
# per-block decode
# ---------------------------------------------------------------------------

def _ffn(bp, spec: T.BlockSpec, x, cfg):
    if spec.ffn == "dense":
        h = L.apply_norm(cfg.norm, x, bp["ln_ffn"])
        x = x + F.ffn_forward(bp["ffn"], h, cfg.activation)
    elif spec.ffn == "moe":
        h = L.apply_norm(cfg.norm, x, bp["ln_ffn"])
        # drop-free, as the reference serves: at the training capacity
        # factor a decode step's b tokens get ~1 slot an expert and ties
        # drop, and prefill must route as decode does for the handoff
        e = bp["moe"]["w_up"].shape[0]
        out, _ = M.moe_forward_auto(bp["moe"], h, top_k=cfg.moe_top_k,
                                    activation=cfg.activation,
                                    capacity_factor=float(e) / cfg.moe_top_k)
        x = x + out
    return x


def _decode_block(bp, spec: T.BlockSpec, x, state, pos: int, cfg,
                  chunk: int):
    """One layer on one token; ``state`` (views into the stacks) is
    updated in place."""
    h = L.apply_norm(cfg.norm, x, bp["ln_attn"])
    if spec.kind == "attn":
        h, _ = A.decode_attention(
            bp["attn"], h, state["self"], pos, n_kv_heads=cfg.n_kv_heads,
            rope_theta=cfg.rope_theta, window=spec.window or None,
            chunk=chunk)
        if spec.cross_attn:
            x = x + h
            h = A.cross_decode(bp["cross"],
                               L.apply_norm(cfg.norm, x, bp["ln_cross"]),
                               state["cross"], n_kv_heads=cfg.n_kv_heads,
                               chunk=chunk)
    elif spec.kind in ("mlstm", "slstm"):
        fwd = X.mlstm_forward if spec.kind == "mlstm" else X.slstm_forward
        h, new = fwd(bp[spec.kind], h, n_heads=cfg.n_heads,
                     state=tuple(state), return_state=True)
        for dst, src in zip(state, new):
            D.local(dst).copy_(D.local(src))
    elif spec.kind == "mamba":
        h, new = S.mamba_decode(bp["mamba"], h, state)
        for k, src in new.items():
            D.local(state[k]).copy_(D.local(src))
    else:
        raise ValueError(spec.kind)
    return _ffn(bp, spec, x + h, cfg)


def _slices(stacks, t: int):
    return tree.map(lambda w: w[t], stacks)


def _top(params, fetch):
    """The parameters outside the decoder's stack (embedding, norms,
    ``lm_head``, an encoder), through ``fetch``."""
    return fetch({k: v for k, v in params.items() if k != "decoder"})


def _same(p):
    return p


@torch.no_grad()
def serve_step(params, cfg, token, states, pos, *, chunk: int = 2048,
               fetch=None):
    """One-token decode.  token: (B, 1) integer; ``pos``: the absolute
    position being generated (an int or a 0-d tensor).  Returns (logits
    (B, V) f32, ``states`` updated in place).  ``fetch`` (FSDP serving:
    ``launch.serve``) maps each layer's parameters, and those outside the
    stack, to the tensors the layer runs on, just before it runs; the
    result is dropped after it."""
    fetch = fetch or _same
    pos = int(pos)
    top = _top(params, fetch)
    x = L.embed(top["embed"], token, L.DTYPES[cfg.dtype])
    specs, per, n_periods = _layout(cfg)
    blocks = params["decoder"]["blocks"]
    for t in range(n_periods):
        for j in range(per):
            x = _decode_block(fetch(_slices(blocks[j], t)), specs[j], x,
                              _slices(states["blocks"][j], t), pos, cfg,
                              chunk)
    for i, tp in enumerate(params["decoder"]["tail"]):
        x = _decode_block(fetch(tp), specs[n_periods * per + i], x,
                          states["tail"][i], pos, cfg, chunk)
    x = L.apply_norm(cfg.norm, x, top["final_norm"])
    return T.logits_fn(top, cfg, x)[:, 0], states


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _prefill_block(bp, spec: T.BlockSpec, x, cfg, chunk: int, memory):
    h = L.apply_norm(cfg.norm, x, bp["ln_attn"])
    if spec.kind == "attn":
        h, cache = A.prefill_attention(
            bp["attn"], h, n_kv_heads=cfg.n_kv_heads,
            rope_theta=cfg.rope_theta, window=spec.window or None,
            chunk=chunk)
        state = {"self": cache}
        if spec.cross_attn and memory is not None:
            x = x + h
            k, v = A.cross_kv(bp["cross"], memory)
            h = A.cross_attend(bp["cross"],
                               L.apply_norm(cfg.norm, x, bp["ln_cross"]),
                               k, v, n_kv_heads=cfg.n_kv_heads, chunk=chunk)
            # tensor-parallel: the whole caches (every head), as the
            # self-attention caches are handed back
            state["cross"] = {"k": _full(k), "v": _full(v)}
    elif spec.kind == "mlstm":
        h, state = X.mlstm_forward(bp["mlstm"], h, n_heads=cfg.n_heads,
                                   return_state=True, chunk=chunk)
    elif spec.kind == "slstm":
        h, state = X.slstm_forward(bp["slstm"], h, n_heads=cfg.n_heads,
                                   return_state=True)
    elif spec.kind == "mamba":
        h, state = S.mamba_forward(bp["mamba"], h, return_state=True)
    else:
        raise ValueError(spec.kind)
    return _ffn(bp, spec, x + h, cfg), state


def _full(x):
    """A ``DTensor``'s full tensor, a plain one as it is."""
    return x.full_tensor() if D.is_dtensor(x) else x


def _stack(xs):
    """Per-period states stacked on a new leading dim; ``DTensor``s (a
    rank's chunks of the recurrent states) stacked locally, their split
    dim moved up by one."""
    if not D.is_dtensor(xs[0]):
        return torch.stack(xs)
    from torch.distributed.tensor import DTensor, Shard
    pl = tuple(Shard(p.dim + 1) if p.is_shard() else p
               for p in xs[0].placements)
    return DTensor.from_local(torch.stack([x.to_local() for x in xs]),
                              xs[0].device_mesh, pl, run_check=False)


@torch.no_grad()
def prefill(params, cfg, tokens, *, frontend_embeds=None, chunk: int = 1024,
            fetch=None):
    """Run the prompt (B, L); return (last-position logits (B, V) f32,
    states).  ``frontend_embeds`` (B, N, D): an encoder-decoder's encoder
    input (its output fills the cross caches), or a VLM's patches ahead
    of the prompt (whose states then hold N + L positions).  ``fetch``:
    as :func:`serve_step`'s (an encoder is fetched whole)."""
    fetch = fetch or _same
    dtype = L.DTYPES[cfg.dtype]
    top = _top(params, fetch)
    x = L.embed(top["embed"], tokens, dtype)
    memory = None
    if cfg.n_encoder_layers:
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs its "
                             f"encoder input (frontend_embeds)")
        mem, _ = T._run_stack(top["encoder"], T.encoder_specs(cfg),
                              frontend_embeds.to(dtype), None, cfg,
                              remat=False, chunk=chunk)
        memory = L.apply_norm(cfg.norm, mem, top["enc_norm"])
    elif frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(dtype), x], dim=1)
    specs, per, n_periods = _layout(cfg)
    blocks = params["decoder"]["blocks"]
    per_t: list[list] = [[] for _ in range(per)]
    for t in range(n_periods):
        for j in range(per):
            x, st = _prefill_block(fetch(_slices(blocks[j], t)), specs[j], x,
                                   cfg, chunk, memory)
            per_t[j].append(st)
    stacked = [tree.map(lambda *xs: _stack(xs), *sts) for sts in per_t
               if sts]
    tail = []
    for i, tp in enumerate(params["decoder"]["tail"]):
        x, st = _prefill_block(fetch(tp), specs[n_periods * per + i], x,
                               cfg, chunk, memory)
        tail.append(st)
    x = L.apply_norm(cfg.norm, x, top["final_norm"])
    logits = T.logits_fn(top, cfg, x[:, -1:])[:, 0]
    return logits, {"blocks": stacked, "tail": tail}
