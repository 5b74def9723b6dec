"""The decoder and encoder-decoder LM stacks of
``repro.models.transformer`` as an ``nn.Module`` over a parameter tree in
the reference's layout.

A model is a sequence of per-layer :class:`BlockSpec` entries derived from
the config (``build_blockspecs``), grouped into the smallest repeating
period (``find_period``): one stacked tree per period position, with a
leading ``n_periods`` axis, and a ``tail`` of unstacked layers that do
not fill a period:

    {"decoder": {"blocks": [stack_0, ..., stack_{p-1}], "tail": [...]},
     "embed": {"embedding"}, "enc_norm"?: {...}, "encoder"?: {"blocks",
     "tail"}, "final_norm": {...}, "lm_head"?: {"w"}}

An attention block holds ``attn/{wq (d,h,hd), wk, wv (d,kv,hd),
wo (h,hd,d)}`` (in an encoder-decoder's decoder also ``cross``, the same
shapes, and ``ln_cross``), ``ffn/{w_gate?, w_up (d,f), w_down (f,d)}`` or, in an
MoE layer (``models.moe``), ``moe/{router (d,E), w_gate?, w_up (E,d,f),
w_down (E,f,d)}``, and the norms ``ln_attn``/``ln_ffn``; an mLSTM or
sLSTM block (``models.xlstm``) holds ``mlstm`` or ``slstm`` and
``ln_attn`` and no FFN; a Mamba block (``models.ssm``: the hybrid's
layers other than attention) holds ``mamba``, ``ln_attn`` and an FFN.
A norm is ``{"scale"}`` (RMS norm) or ``{"bias", "scale"}`` (layer
norm).  The flatten order of the
tree — and so every per-leaf budget and leaf id — is the reference's.

``loss_fn(params, cfg, batch)`` is functional, like the reference's;
:class:`Transformer` owns the parameters.  :func:`from_jax_params` and
:func:`to_numpy_tree` carry the reference's parameters, as numpy arrays,
into the port and back.  Attention layers may be windowed
(``sliding_window``, every layer or the local ones of a local/global
interleave).  ``forward`` returns the MoE layers' load-balance loss,
summed over the layers in order.  ``forward(remat=True)`` and
``loss_fn(remat=True)``, the reference's default, keep no activation
inside a period of the stack and recompute the period in the backward
(``torch.utils.checkpoint``); ``remat=False`` keeps them all.

``forward(frontend_embeds=)`` takes a frontend's embeddings (B, N, D):
an encoder-decoder (``n_encoder_layers``) runs its encoder stack on
them, as the reference does (causal, rotary self-attention: its
``attention_forward`` with no window), then ``enc_norm``, and each
decoder layer attends over that ``memory``; a VLM puts them (image
patches) ahead of the token embeddings, at rope positions ``0 … N - 1``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import resolve_device, tree
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str            # attn | mamba | mlstm | slstm
    ffn: str             # dense | moe | none
    window: int | None   # sliding window (None = full)
    cross_attn: bool = False


def build_blockspecs(cfg) -> list[BlockSpec]:
    """Per-layer block specs for the decoder stack."""
    specs = []
    for i in range(cfg.n_layers):
        kind = "attn"
        if cfg.attn_period:  # hybrid (jamba): 1 attn per period, rest mamba
            kind = "attn" if (i % cfg.attn_period) == (cfg.attn_period // 2) \
                else "mamba"
        if cfg.xlstm_pattern:
            kind = cfg.xlstm_pattern[i % len(cfg.xlstm_pattern)]
        ffn = "dense"
        if kind in ("mlstm", "slstm"):
            ffn = "none"  # xLSTM blocks carry their own projections
        elif cfg.n_experts:
            ffn = "moe" if (i % cfg.moe_period) == (cfg.moe_period - 1) \
                or cfg.moe_period == 1 else "dense"
        window = None
        if cfg.sliding_window:
            if cfg.local_global_period:
                is_global = (i % cfg.local_global_period
                             == cfg.local_global_period - 1)
                window = None if is_global else cfg.sliding_window
            else:
                window = cfg.sliding_window
        specs.append(BlockSpec(kind=kind, ffn=ffn, window=window,
                               cross_attn=bool(cfg.n_encoder_layers)))
    return specs


def find_period(specs: list[BlockSpec]) -> int:
    n = len(specs)
    for p in range(1, n + 1):
        n_periods = n // p
        if n_periods == 0:
            break
        ok = all(specs[i] == specs[i % p] for i in range(n_periods * p))
        if ok and n_periods >= 1 and (n - n_periods * p) < p:
            return p
    return n


def encoder_specs(cfg) -> list[BlockSpec]:
    """The encoder stack's layers: dense attention blocks, no window,
    no cross-attention."""
    return [BlockSpec("attn", "dense", None, False)] * cfg.n_encoder_layers


def _attn_specs(cfg) -> tuple[dict, dict]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s_in, s_out = 1 / math.sqrt(d), 1 / math.sqrt(h * hd)
    return ({"wq": ((d, h, hd), s_in), "wk": ((d, kv, hd), s_in),
             "wv": ((d, kv, hd), s_in), "wo": ((h, hd, d), s_out)},
            {"wq": ("embed", "heads", "head_dim"),
             "wk": ("embed", "kv_heads", "head_dim"),
             "wv": ("embed", "kv_heads", "head_dim"),
             "wo": ("heads", "head_dim", "embed")})


def _block(cfg, spec: BlockSpec) -> tuple[dict, dict]:
    """(leaf specs as (shape, init), logical axes) of one layer: normal
    times a scale, a constant (``layers.Full``) or computed values
    (``layers.Values``)."""
    d = cfg.d_model
    norm = L.norm_specs(cfg.norm, (d,))
    norm_ax = L.norm_axes(cfg.norm, ("embed",))
    p: dict = {}
    ax: dict = {}
    if spec.kind == "attn":
        p["attn"], ax["attn"] = _attn_specs(cfg)
        if spec.cross_attn:
            p["cross"], ax["cross"] = _attn_specs(cfg)
            p["ln_cross"], ax["ln_cross"] = norm, norm_ax
    elif spec.kind == "mamba":
        p["mamba"], ax["mamba"] = S.mamba_specs(d)
    elif spec.kind == "mlstm":
        p["mlstm"], ax["mlstm"] = X.mlstm_specs(d, cfg.n_heads)
    elif spec.kind == "slstm":
        p["slstm"], ax["slstm"] = X.slstm_specs(d, cfg.n_heads)
    if spec.ffn == "dense":
        f = cfg.d_ff
        s_in, s_ff = 1 / math.sqrt(d), 1 / math.sqrt(f)
        p["ffn"] = {"w_up": ((d, f), s_in), "w_down": ((f, d), s_ff)}
        ax["ffn"] = {"w_up": ("embed", "ffn"), "w_down": ("ffn", "embed")}
        if cfg.gated_ffn:
            p["ffn"]["w_gate"] = ((d, f), s_in)
            ax["ffn"]["w_gate"] = ("embed", "ffn")
    elif spec.ffn == "moe":
        p["moe"], ax["moe"] = M.moe_specs(d, cfg.d_ff, cfg.n_experts,
                                          gated=cfg.gated_ffn)
    p["ln_attn"], ax["ln_attn"] = norm, norm_ax
    if spec.ffn in ("dense", "moe"):
        p["ln_ffn"], ax["ln_ffn"] = norm, norm_ax
    return p, ax


def _stack_layout(cfg, specs) -> tuple[dict, dict]:
    """(leaf specs, logical axes) of one stack: ``_init_stack``'s
    grouping into period stacks (a leading ``layers`` axis of
    ``n_periods``) and the unstacked tail."""
    per = find_period(specs)
    n_periods = len(specs) // per
    blocks, blocks_ax = [], []
    for j in range(per):
        p, ax = _block(cfg, specs[j])
        blocks.append(_map_specs(
            lambda sp: ((n_periods,) + tuple(sp[0]), sp[1]), p))
        blocks_ax.append(_map_axes(lambda a: ("layers",) + a, ax))
    tail = [_block(cfg, specs[i]) for i in range(n_periods * per,
                                                  len(specs))]
    return ({"blocks": blocks, "tail": [t[0] for t in tail]},
            {"blocks": blocks_ax, "tail": [t[1] for t in tail]})


def _layout(cfg) -> tuple[dict, dict]:
    """(leaf specs, logical axes) of the whole tree: the decoder stack,
    and an encoder-decoder's encoder stack and ``enc_norm``."""
    d = cfg.d_model
    dec, dec_ax = _stack_layout(cfg, build_blockspecs(cfg))
    out = {"decoder": dec,
           "embed": {"embedding": ((cfg.vocab, d), 1 / math.sqrt(d))},
           "final_norm": L.norm_specs(cfg.norm, (d,))}
    axes = {"decoder": dec_ax,
            "embed": {"embedding": ("vocab", "embed")},
            "final_norm": L.norm_axes(cfg.norm, ("embed",))}
    if cfg.n_encoder_layers:
        out["encoder"], axes["encoder"] = _stack_layout(cfg,
                                                        encoder_specs(cfg))
        out["enc_norm"] = L.norm_specs(cfg.norm, (d,))
        axes["enc_norm"] = L.norm_axes(cfg.norm, ("embed",))
    if not cfg.tie_embeddings:
        out["lm_head"] = {"w": ((d, cfg.vocab), 1 / math.sqrt(d))}
        axes["lm_head"] = {"w": ("embed", "vocab")}
    return out, axes


def _shapes(cfg) -> dict:
    """Leaf shapes and inits, ``(shape, init)`` with ``init`` a normal's
    scale, a constant (``layers.Full``) or computed values
    (``layers.Values``)."""
    return _layout(cfg)[0]


def logical_axes(cfg) -> dict:
    """Each leaf's logical axis names, in the params' structure (the
    reference's ``init_model`` axes tree, ``None`` entries included):
    what ``sharding.rules`` maps onto mesh axes."""
    return _layout(cfg)[1]


def init_params(cfg, *, seed: int = 0, device="cuda") -> dict:
    """Random parameters from ``seed`` (a ``torch.Generator`` on the
    device: the same distributions as the reference's init, not the same
    draws)."""
    dev = resolve_device(device)
    dtype = L.DTYPES[cfg.param_dtype]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(spec):
        shape, init = spec
        if isinstance(init, L.Full):
            return torch.full(shape, init.value, dtype=dtype, device=dev)
        if isinstance(init, L.Values):
            # the same values in every layer of a stacked leaf
            return init.fn().to(device=dev, dtype=dtype).expand(
                shape).contiguous()
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return w.mul_(init).to(dtype)

    return _map_specs(make, _shapes(cfg))


def abstract_params(cfg) -> dict:
    """The parameter tree as ``meta`` tensors: shapes and dtypes, no
    storage (the counterpart of the reference's ``eval_shape`` of
    ``init_model``)."""
    dtype = L.DTYPES[cfg.param_dtype]
    return _map_specs(lambda spec: torch.empty(spec[0], dtype=dtype,
                                               device="meta"), _shapes(cfg))


def _map_specs(fn, specs):
    """``fn`` over the ``(shape, init)`` leaves of a spec tree."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return fn(specs)


def _is_axes(a) -> bool:
    """An axis-name tuple: a leaf of an axes tree."""
    return isinstance(a, tuple) and all(isinstance(x, (str, type(None)))
                                        for x in a)


def _map_axes(fn, axes):
    """``fn`` over the axis-name tuples of an axes tree of dicts and
    tuples (the reference's ``jax.tree.map(..., is_leaf=)``)."""
    if _is_axes(axes):
        return fn(axes)
    if isinstance(axes, dict):
        return {k: _map_axes(fn, v) for k, v in axes.items()}
    return type(axes)(_map_axes(fn, v) for v in axes)


def _apply_block(bp, spec: BlockSpec, x, cfg, *, chunk: int,
                 moe_groups: int = 1, memory=None):
    """One layer -> (x, its MoE load-balance loss, or None).  ``chunk``:
    the sequence chunk of attention's keys and of the mLSTM's scan;
    ``memory``: the encoder's output, which a cross-attention layer
    attends over."""
    h = L.apply_norm(cfg.norm, x, bp["ln_attn"])
    if spec.kind == "attn":
        h = A.attention_forward(bp["attn"], h, n_kv_heads=cfg.n_kv_heads,
                                rope_theta=cfg.rope_theta,
                                window=spec.window or None, chunk=chunk)
    elif spec.kind == "mamba":
        h = S.mamba_forward(bp["mamba"], h)
    elif spec.kind == "mlstm":
        h = X.mlstm_forward(bp["mlstm"], h, n_heads=cfg.n_heads, chunk=chunk)
    else:
        h = X.slstm_forward(bp["slstm"], h, n_heads=cfg.n_heads)
    x = x + h
    if spec.cross_attn and memory is not None and spec.kind == "attn":
        h = L.apply_norm(cfg.norm, x, bp["ln_cross"])
        x = x + A.cross_attention_forward(bp["cross"], h, memory,
                                          n_kv_heads=cfg.n_kv_heads,
                                          chunk=chunk)
    if spec.ffn == "dense":
        h = L.apply_norm(cfg.norm, x, bp["ln_ffn"])
        x = x + F.ffn_forward(bp["ffn"], h, cfg.activation)
    elif spec.ffn == "moe":
        h = L.apply_norm(cfg.norm, x, bp["ln_ffn"])
        out, aux = M.moe_forward_auto(bp["moe"], h, top_k=cfg.moe_top_k,
                                      activation=cfg.activation,
                                      groups=moe_groups)
        return x + out, aux
    return x, None


def _period(blocks, specs, x, aux, cfg, **kw):
    """One period of the stack: its layer j is ``blocks[j]``."""
    for bp, spec in zip(blocks, specs):
        x, a = _apply_block(bp, spec, x, cfg, **kw)
        aux = aux if a is None else aux + a
    return x, aux


def _run_stack(stack, specs, x, aux, cfg, *, remat: bool, **kw):
    """One stack (``{"blocks", "tail"}``) over ``x``, layer by layer,
    period by period, as the reference's scan runs; ``aux`` carries the
    MoE layers' loss.  ``remat``: each period under a non-reentrant
    checkpoint, the tail not, as in the reference."""
    per = find_period(specs)
    n_periods = len(specs) // per
    stacks = []
    for blocks in stack["blocks"]:
        flat, treedef = tree.flatten(blocks)
        # one unbind per leaf, outside the checkpoints: one gradient
        # buffer per stacked leaf, whose hook fires once
        stacks.append((treedef, [w.unbind(0) for w in flat]))
    for t in range(n_periods):
        # layer t·p + j is position j of period t
        blocks = [tree.unflatten(treedef, [w[t] for w in per_layer])
                  for treedef, per_layer in stacks]
        if remat:
            # no random draws to replay; the checkpoint walks its
            # arguments, so it gets this period's leaves only
            x, aux = torch.utils.checkpoint.checkpoint(
                _period, blocks, specs[:per], x, aux, cfg,
                use_reentrant=False, preserve_rng_state=False, **kw)
        else:
            x, aux = _period(blocks, specs[:per], x, aux, cfg, **kw)
    for i, bp in enumerate(stack["tail"]):
        x, a = _apply_block(bp, specs[n_periods * per + i], x, cfg, **kw)
        aux = aux if a is None else aux + a
    return x, aux


def forward(params, cfg, tokens, *, frontend_embeds=None, chunk: int = 1024,
            remat: bool = True, moe_groups: int = 1):
    """tokens (B, S) -> (final hidden states (B, S_total, D), the MoE
    layers' aux loss, f32, added layer after layer from 0 as the
    reference's scan carries it).

    ``frontend_embeds`` (B, N, D): an encoder-decoder's encoder input
    (required there), or a VLM's patch embeddings, put ahead of the
    tokens (S_total = N + S).

    ``remat`` (with gradients on): each period of each stack runs under
    a non-reentrant ``torch.utils.checkpoint`` and is recomputed in the
    backward; the tail layers are not, as in the reference.  The
    recompute repeats the forward bit for bit (so ``wave`` == ``off``
    and the step-0 replays hold): nothing in a period draws random
    numbers or adds in an order that varies, the MoE router sorts
    stably and its dispatch and combine are collision-free gathers
    (no atomics).  The encoder's output feeds every decoder period, so
    its gradient is summed over them before it reaches the encoder.

    ``moe_groups``: the token groups each MoE layer dispatches apart,
    each with its own capacity (``models.moe.moe_forward_grouped``)."""
    dtype = L.DTYPES[cfg.dtype]
    x = L.embed(params["embed"], tokens, dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kw = dict(chunk=chunk, moe_groups=moe_groups,
              remat=remat and torch.is_grad_enabled())
    memory = None
    if cfg.n_encoder_layers:
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs its "
                             f"encoder input (frontend_embeds)")
        mem, aux = _run_stack(params["encoder"], encoder_specs(cfg),
                              frontend_embeds.to(dtype), aux, cfg, **kw)
        memory = L.apply_norm(cfg.norm, mem, params["enc_norm"])
    elif frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(dtype), x], dim=1)
    x, aux = _run_stack(params["decoder"], build_blockspecs(cfg), x, aux,
                        cfg, memory=memory, **kw)
    x = L.apply_norm(cfg.norm, x, params["final_norm"])
    return x, aux


def logits_fn(params, cfg, hidden):
    if cfg.tie_embeddings:
        return _whole_rows(L.unembed(params["embed"], hidden))
    return _whole_rows(torch.einsum("...d,dv->...v", hidden.float(),
                                    params["lm_head"]["w"].float()))


def _whole_rows(logits):
    """Logits sharded over the vocab (a tensor-parallel ``DTensor``)
    gathered to whole rows, which the loss's gather of the gold logit
    reads; plain logits as they are."""
    if type(logits) is torch.Tensor:
        return logits
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(logits, DTensor) and not all(
            p.is_replicate() for p in logits.placements):
        logits = logits.redistribute(
            logits.device_mesh, [Replicate()] * logits.device_mesh.ndim)
    return logits


def loss_fn(params, cfg, batch, *, chunk: int = 1024, remat: bool = True,
            loss_chunk: int = 512, aux_weight: float = 0.01,
            moe_groups: int = 1):
    """Mean next-token cross-entropy over ``batch`` = {"tokens" (B, S),
    "labels" (B, S) (label -1 = masked), "frontend_embeds"?}.  The loss
    covers the last ``S`` positions only (a VLM's patches carry none).
    The vocab projection runs in sequence chunks of ``loss_chunk``; like
    the reference, the ``s % loss_chunk`` remainder tokens are dropped.
    ``remat`` and ``moe_groups``: as :func:`forward`'s."""
    hidden, aux = forward(params, cfg, batch["tokens"],
                          frontend_embeds=batch.get("frontend_embeds"),
                          chunk=chunk, remat=remat, moe_groups=moe_groups)
    labels = batch["labels"]
    hidden = hidden[:, -labels.shape[1]:]
    b, s, d = hidden.shape
    lc = min(loss_chunk, s)
    n_chunks = s // lc
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        h = hidden[:, c * lc:(c + 1) * lc]
        y = labels[:, c * lc:(c + 1) * lc]
        logits = logits_fn(params, cfg, h)                 # (B, lc, V) f32
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            torch.clamp_min(y, 0)[..., None].long())[..., 0]
        mask = (y >= 0).float()
        tot = tot + ((logz - gold) * mask).sum()
        cnt = cnt + mask.sum()
    loss = tot / torch.clamp_min(cnt, 1.0)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


class Transformer(nn.Module):
    """Owns the parameter tree (``self.params``, nested dicts and lists
    of ``nn.Parameter`` in the reference layout) of one model.

    ``device`` defaults to ``cuda`` and raises without a card."""

    def __init__(self, cfg, *, seed: int = 0, device="cuda", params=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, seed=seed, device=dev)
        self.params = tree.map(
            lambda t: nn.Parameter(t.to(dev), requires_grad=True), params)
        for path, p in zip(tree.leaf_paths(self.params),
                           tree.leaves(self.params)):
            self.register_parameter(path.replace("/", "__"), p)

    def forward(self, tokens, *, frontend_embeds=None, chunk: int = 1024,
                remat: bool = True):
        return forward(self.params, self.cfg, tokens,
                       frontend_embeds=frontend_embeds, chunk=chunk,
                       remat=remat)


def from_jax_params(np_tree, cfg, *, device="cuda") -> Transformer:
    """A :class:`Transformer` holding the reference's parameters, given as
    a tree of numpy arrays (``jax.tree.map(np.asarray, params)``).  bf16
    arrays arrive through f32, exactly."""
    dtype = L.DTYPES[cfg.param_dtype]

    def to_torch(a):
        a = np.asarray(a)
        a = np.array(a, np.float32 if a.dtype.name == "bfloat16" else a.dtype)
        return torch.from_numpy(a).to(dtype)

    return Transformer(cfg, device=device, params=tree.map(to_torch, np_tree))


def to_numpy_tree(module: Transformer) -> dict:
    """The module's parameters as a tree of numpy arrays (f32 for bf16)."""
    def to_np(p):
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree.map(to_np, module.params)
