"""Grouped-query attention with the causal online softmax of
``repro.models.attention.chunked_attention``, in plain PyTorch.

Layouts are the reference's: ``wq`` (d, h, hd), ``wk``/``wv``
(d, kv, hd), ``wo`` (h, hd, d); queries grouped as (B, S, KV, G, hd).
Scores exist only per KV chunk, (B, KV, G, Sq, chunk), with the
running (max, sum, acc) state in f32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L

NEG_INF = -1e30


def _qkv(p, x, n_kv_heads):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv_heads, h // n_kv_heads, hd), k, v


def _out_proj(p, o, dtype):
    """o: (B, S, KV, G, hd) -> (B, S, D)."""
    b, s, kv, g, hd = o.shape
    o = o.reshape(b, s, kv * g, hd)
    return torch.einsum("bshk,hkd->bsd", o.to(dtype), p["wo"].to(dtype))


def chunked_attention(q, k, v, *, q_positions, k_positions, causal=True,
                      chunk: int = 1024):
    """Online-softmax attention over KV chunks.

    q: (B, Sq, KV, G, hd); k, v: (B, Sk, KV, hd); positions: (Sq,), (Sk,).
    Returns (B, Sq, KV, G, hd) in q's dtype."""
    b, sq, kvh, g, hd = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = torch.nn.functional.pad(k_positions, (0, pad),
                                              value=2 ** 30)
    scale = 1.0 / math.sqrt(hd)
    qf = (q.float() * scale).permute(0, 2, 3, 1, 4)      # B,KV,G,Sq,hd
    kc = k.reshape(b, n_chunks, chunk, kvh, hd).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, n_chunks, chunk, kvh, hd).permute(1, 0, 3, 2, 4)
    kpos_c = k_positions.reshape(n_chunks, chunk)

    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=torch.float32,
                      device=q.device)
    for j in range(n_chunks):
        s = torch.einsum("bhgqd,bhcd->bhgqc", qf, kc[j].float())
        if causal:
            mask = kpos_c[j][None, :] <= q_positions[:, None]
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p_ = torch.exp(s - m_new[..., None])
        l = l * corr + p_.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqc,bhcd->bhgqd", p_, vc[j].float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)        # B,Sq,KV,G,hd


def attention_forward(p, x, *, n_kv_heads: int, rope_theta: float = 10000.0,
                      chunk: int = 1024):
    """Causal self-attention (training path) with rotary embedding."""
    b, s, d = x.shape
    q, k, v = _qkv(p, x, n_kv_heads)
    positions = torch.arange(s, device=x.device)
    _, _, kvh, g, hd = q.shape
    q = L.apply_rope(q.reshape(b, s, kvh * g, hd), positions,
                     rope_theta).reshape(b, s, kvh, g, hd)
    k = L.apply_rope(k, positions, rope_theta)
    o = chunked_attention(q, k, v, q_positions=positions,
                          k_positions=positions, causal=True, chunk=chunk)
    return _out_proj(p, o, x.dtype)
