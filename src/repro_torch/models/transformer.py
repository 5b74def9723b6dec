"""Decoder-only transformer LM (the ``dense`` family of
``repro.models.transformer``) as an ``nn.Module`` over a parameter tree
in the reference's layout:

    {"decoder": {"blocks": [stack], "tail": []}, "embed": {"embedding"},
     "final_norm": {"scale"}, "lm_head"?: {"w"}}

where ``stack`` holds every layer's weights stacked on a leading
``n_layers`` axis (``attn/{wq (L,d,h,hd), wk, wv (L,d,kv,hd),
wo (L,h,hd,d)}``, ``ffn/{w_gate, w_up (L,d,f), w_down (L,f,d)}``,
``ln_attn``/``ln_ffn`` ``{"scale" (L,d)}``).  The flatten order of that
tree — and so every per-leaf budget and leaf id — is the reference's.

``loss_fn(params, cfg, batch)`` is functional, like the reference's;
:class:`Transformer` owns the parameters.  :func:`from_jax_params` and
:func:`to_numpy_tree` carry the reference's parameters, as numpy arrays,
into the port and back.  Families other than ``dense`` raise.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device, tree
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import layers as L


def check_supported(cfg) -> None:
    """Raise for what this slice has not ported."""
    unported = {
        "family": cfg.family != "dense",
        "sliding_window": cfg.sliding_window is not None,
        "n_experts": bool(cfg.n_experts),
        "attn_period": cfg.attn_period is not None,
        "xlstm_pattern": cfg.xlstm_pattern is not None,
        "n_encoder_layers": bool(cfg.n_encoder_layers),
        "frontend": cfg.frontend is not None,
        "norm": cfg.norm != "rmsnorm",
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {bad} not ported yet (ROADMAP.md queue 1 item 13: "
            f"the remaining model families); the port runs dense "
            f"rmsnorm decoders")


def _shapes(cfg) -> dict:
    """Leaf shapes and init scales (normal * scale; None = zeros)."""
    n, d, h, kv, hd, f = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.n_kv_heads, cfg.hd, cfg.d_ff)
    s_in, s_out, s_ff = 1 / math.sqrt(d), 1 / math.sqrt(h * hd), \
        1 / math.sqrt(f)
    ffn = {"w_up": ((n, d, f), s_in), "w_down": ((n, f, d), s_ff)}
    if cfg.gated_ffn:
        ffn["w_gate"] = ((n, d, f), s_in)
    stack = {
        "attn": {"wq": ((n, d, h, hd), s_in), "wk": ((n, d, kv, hd), s_in),
                 "wv": ((n, d, kv, hd), s_in), "wo": ((n, h, hd, d), s_out)},
        "ffn": ffn,
        "ln_attn": {"scale": ((n, d), None)},
        "ln_ffn": {"scale": ((n, d), None)},
    }
    out = {"decoder": {"blocks": [stack], "tail": []},
           "embed": {"embedding": ((cfg.vocab, d), s_in)},
           "final_norm": {"scale": ((d,), None)}}
    if not cfg.tie_embeddings:
        out["lm_head"] = {"w": ((d, cfg.vocab), s_in)}
    return out


def logical_axes(cfg) -> dict:
    """Each leaf's logical axis names, in the params' structure (the
    reference's ``init_model`` axes tree): what ``sharding.rules`` maps
    onto mesh axes."""
    def stacked(*names):
        return ("layers",) + names
    ffn = {"w_up": stacked("embed", "ffn"), "w_down": stacked("ffn", "embed")}
    if cfg.gated_ffn:
        ffn["w_gate"] = stacked("embed", "ffn")
    stack = {
        "attn": {"wq": stacked("embed", "heads", "head_dim"),
                 "wk": stacked("embed", "kv_heads", "head_dim"),
                 "wv": stacked("embed", "kv_heads", "head_dim"),
                 "wo": stacked("heads", "head_dim", "embed")},
        "ffn": ffn,
        "ln_attn": {"scale": stacked("embed")},
        "ln_ffn": {"scale": stacked("embed")},
    }
    out = {"decoder": {"blocks": [stack], "tail": []},
           "embed": {"embedding": ("vocab", "embed")},
           "final_norm": {"scale": ("embed",)}}
    if not cfg.tie_embeddings:
        out["lm_head"] = {"w": ("embed", "vocab")}
    return out


def init_params(cfg, *, seed: int = 0, device="cuda") -> dict:
    """Random parameters from ``seed`` (a ``torch.Generator`` on the
    device: the same distributions as the reference's init, not the same
    draws)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = L.DTYPES[cfg.param_dtype]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(spec):
        shape, scale = spec
        if scale is None:
            return torch.zeros(shape, dtype=dtype, device=dev)
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return w.mul_(scale).to(dtype)

    return _map_specs(make, _shapes(cfg))


def abstract_params(cfg) -> dict:
    """The parameter tree as ``meta`` tensors: shapes and dtypes, no
    storage (the counterpart of the reference's ``eval_shape`` of
    ``init_model``)."""
    check_supported(cfg)
    dtype = L.DTYPES[cfg.param_dtype]
    return _map_specs(lambda spec: torch.empty(spec[0], dtype=dtype,
                                               device="meta"), _shapes(cfg))


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return fn(specs)


def _apply_block(bp, x, cfg, *, chunk: int):
    h = L.apply_norm(cfg.norm, x, bp["ln_attn"])
    x = x + A.attention_forward(bp["attn"], h, n_kv_heads=cfg.n_kv_heads,
                                rope_theta=cfg.rope_theta, chunk=chunk)
    h = L.apply_norm(cfg.norm, x, bp["ln_ffn"])
    return x + F.ffn_forward(bp["ffn"], h, cfg.activation)


def forward(params, cfg, tokens, *, chunk: int = 1024):
    """tokens (B, S) -> (final hidden states (B, S, D), aux loss 0)."""
    x = L.embed(params["embed"], tokens, L.DTYPES[cfg.dtype])
    for stack in params["decoder"]["blocks"]:
        flat, treedef = tree.flatten(stack)
        per_layer = [w.unbind(0) for w in flat]   # one grad buffer per leaf
        for i in range(len(per_layer[0]) if per_layer else 0):
            bp = tree.unflatten(treedef, [w[i] for w in per_layer])
            x = _apply_block(bp, x, cfg, chunk=chunk)
    for bp in params["decoder"]["tail"]:
        x = _apply_block(bp, x, cfg, chunk=chunk)
    x = L.apply_norm(cfg.norm, x, params["final_norm"])
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(params, cfg, hidden):
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], hidden)
    return torch.einsum("...d,dv->...v", hidden.float(),
                        params["lm_head"]["w"].float())


def loss_fn(params, cfg, batch, *, chunk: int = 1024, loss_chunk: int = 512,
            aux_weight: float = 0.01):
    """Mean next-token cross-entropy over ``batch`` = {"tokens" (B, S),
    "labels" (B, S) (label -1 = masked)}.  The vocab projection runs in
    sequence chunks of ``loss_chunk``; like the reference, the
    ``s % loss_chunk`` remainder tokens are dropped."""
    hidden, aux = forward(params, cfg, batch["tokens"], chunk=chunk)
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
    """Owns the parameter tree (``self.params``, nested dicts of
    ``nn.Parameter`` in the reference layout) of one dense decoder.

    ``device`` defaults to ``cuda`` and raises without a card."""

    def __init__(self, cfg, *, seed: int = 0, device="cuda", params=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, seed=seed, device=dev)
        self.params = tree.map(
            lambda t: nn.Parameter(t.to(dev), requires_grad=True), params)
        for path, p in zip(tree.leaf_paths(self.params),
                           tree.leaves(self.params)):
            self.register_parameter(path.replace("/", "__"), p)

    def forward(self, tokens, *, chunk: int = 1024):
        return forward(self.params, self.cfg, tokens, chunk=chunk)


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
