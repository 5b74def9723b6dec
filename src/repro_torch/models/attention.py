"""Grouped-query attention with the online softmax of
``repro.models.attention.chunked_attention``, sliding windows, the
encoder's and the decoder's cross-attention and the KV-cache decode
path, in plain PyTorch.

Layouts are the reference's: ``wq`` (d, h, hd), ``wk``/``wv``
(d, kv, hd), ``wo`` (h, hd, d); queries grouped as (B, S, KV, G, hd).
Scores exist only per KV chunk, (B, KV, G, Sq, chunk), with the
running (max, sum, acc) state in f32.

Cache layouts (the reference's):
  full cache : k/v (B, S_cap, KV, hd); entries at index <= pos are valid.
  ring cache : k/v (B, W, KV, hd) for a windowed layer; token ``pos`` at
               slot ``pos % W``.
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
                      window: int | None = None, chunk: int = 1024,
                      k_valid_len=None):
    """Online-softmax attention over KV chunks.

    q: (B, Sq, KV, G, hd); k, v: (B, Sk, KV, hd); positions: (Sq,), (Sk,).
    ``window``: keys more than ``window - 1`` positions before a query
    are masked; ``k_valid_len`` (an int or a 0-d integer tensor): keys
    at index >= it are masked.  Padding the keys to whole chunks masks
    the pad the same way.  Returns (B, Sq, KV, G, hd) in q's dtype.

    Tensor-parallel ``DTensor`` inputs run on this rank's KV heads
    (:func:`_local_heads`)."""
    if type(q) is not torch.Tensor:
        return _local_heads(chunked_attention, q, k, v,
                            q_positions=q_positions, k_positions=k_positions,
                            causal=causal, window=window, chunk=chunk,
                            k_valid_len=k_valid_len)
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
        if k_valid_len is None:
            k_valid_len = sk
    scale = 1.0 / math.sqrt(hd)
    qf = (q.float() * scale).permute(0, 2, 3, 1, 4)      # B,KV,G,Sq,hd
    kc = k.reshape(b, n_chunks, chunk, kvh, hd).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, n_chunks, chunk, kvh, hd).permute(1, 0, 3, 2, 4)
    kpos_c = k_positions.reshape(n_chunks, chunk)
    kidx_c = torch.arange(n_chunks * chunk,
                          device=q.device).reshape(n_chunks, chunk)

    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=torch.float32,
                      device=q.device)
    for j in range(n_chunks):
        s = torch.einsum("bhgqd,bhcd->bhgqc", qf, kc[j].float())
        mask = None
        if causal:
            mask = kpos_c[j][None, :] <= q_positions[:, None]
        if window is not None:
            win = kpos_c[j][None, :] > q_positions[:, None] - window
            mask = win if mask is None else mask & win
        if k_valid_len is not None:
            valid = (kidx_c[j] < k_valid_len)[None, :]
            mask = valid if mask is None else mask & valid
        if mask is not None:
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


def _local_heads(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` on this rank's KV heads when q, k and v are
    ``DTensor``s over a tensor-parallel 'model' axis.  Attention is
    independent per KV head, so each rank runs ``fn`` on its own (all
    three sharded on the KV dim, 2) and the output keeps that sharding;
    other layouts are replicated first.  (DTensor's own propagation of
    the score products would flatten (batch, head) with the head dim
    sharded, a layout older torch versions refuse.)"""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(q, DTensor):
        return fn(q, k, v, **kw)
    mesh = q.device_mesh
    heads = (Shard(2),) * mesh.ndim
    if not (tuple(q.placements) == tuple(k.placements)
            == tuple(v.placements) == heads):
        heads = (Replicate(),) * mesh.ndim
        q, k, v = (t.redistribute(mesh, heads) for t in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local(), **kw)
    return DTensor.from_local(out, mesh, heads, run_check=False)


def _window(window):
    """The mask width of a layer's ``window`` (None and -1: no window)."""
    return None if window in (None, -1) else window


def _rope_qk(q, k, positions, rope_theta):
    b, s, kvh, g, hd = q.shape
    q = L.apply_rope(q.reshape(b, s, kvh * g, hd), positions,
                     rope_theta).reshape(b, s, kvh, g, hd)
    return q, L.apply_rope(k, positions, rope_theta)


def attention_forward(p, x, *, n_kv_heads: int, rope_theta: float = 10000.0,
                      window: int | None = None, chunk: int = 1024,
                      positions=None, use_rope: bool = True):
    """Self-attention (training and encoding path): causal unless
    ``window`` is -1, masked to the last ``window`` positions when it is
    a width; rotary embedding at ``positions`` (default ``0 … S - 1``)
    unless ``use_rope`` is False."""
    b, s, d = x.shape
    q, k, v = _qkv(p, x, n_kv_heads)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    if use_rope:
        q, k = _rope_qk(q, k, positions, rope_theta)
    o = chunked_attention(q, k, v, q_positions=positions,
                          k_positions=positions, causal=window != -1,
                          window=_window(window), chunk=chunk)
    return _out_proj(p, o, x.dtype)


def attention_encoder(p, x, *, n_kv_heads: int, chunk: int = 1024):
    """Bidirectional self-attention without rotary embedding."""
    return attention_forward(p, x, n_kv_heads=n_kv_heads, window=-1,
                             chunk=chunk, use_rope=False)


def cross_kv(p, memory):
    """The keys and values (B, Sm, KV, hd) of a cross-attention layer
    over the encoder's output ``memory`` (B, Sm, D)."""
    k = torch.einsum("bsd,dhk->bshk", memory, p["wk"].to(memory.dtype))
    v = torch.einsum("bsd,dhk->bshk", memory, p["wv"].to(memory.dtype))
    return k, v


def cross_attend(p, x, k, v, *, n_kv_heads: int, chunk: int = 1024):
    """Queries of ``x`` (B, S, D) over every one of the keys and values
    ``k``, ``v`` (B, Sm, KV, hd): no rotary embedding, no mask."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    b, s, h, hd = q.shape
    q = q.reshape(b, s, n_kv_heads, h // n_kv_heads, hd)
    o = chunked_attention(
        q, k.to(x.dtype), v.to(x.dtype),
        q_positions=torch.zeros((s,), dtype=torch.long, device=x.device),
        k_positions=torch.zeros((k.shape[1],), dtype=torch.long,
                                device=x.device),
        causal=False, chunk=chunk)
    return _out_proj(p, o, x.dtype)


def cross_attention_forward(p, x, memory, *, n_kv_heads: int,
                            chunk: int = 1024):
    """Decoder cross-attention over the encoder's output ``memory``
    (B, Sm, D): no rotary embedding, not causal."""
    k, v = cross_kv(p, memory)
    return cross_attend(p, x, k, v, n_kv_heads=n_kv_heads, chunk=chunk)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def init_cache(batch: int, capacity: int, n_kv_heads: int, head_dim: int,
               dtype, device) -> dict:
    shape = (batch, capacity, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_axes() -> dict:
    """The reference's logical axes of a cache: batch over the data axes,
    the sequence over ``model`` (one device here: names only)."""
    return {"k": ("cache_batch", "cache_seq", None, None),
            "v": ("cache_batch", "cache_seq", None, None)}


def prefill_attention(p, x, *, n_kv_heads: int, rope_theta: float = 10000.0,
                      window: int | None = None, chunk: int = 1024):
    """Forward, and the populated cache: the whole prompt's keys and
    values, or its last ``window`` of them for a windowed layer."""
    b, s, d = x.shape
    q, k, v = _qkv(p, x, n_kv_heads)
    positions = torch.arange(s, device=x.device)
    q, k = _rope_qk(q, k, positions, rope_theta)
    win = _window(window)
    o = chunked_attention(q, k, v, q_positions=positions,
                          k_positions=positions, causal=True, window=win,
                          chunk=chunk)
    out = _out_proj(p, o, x.dtype)
    if win is not None and win < s:
        return out, {"k": k[:, -win:], "v": v[:, -win:]}
    return out, {"k": k, "v": v}


def decode_attention(p, x, cache, pos: int, *, n_kv_heads: int,
                     rope_theta: float = 10000.0, window: int | None = None,
                     chunk: int = 2048):
    """One-token decode.  x: (B, 1, D); ``pos``: the token's absolute
    position.  Writes its key and value into ``cache`` IN PLACE (the
    reference donates the cache) and returns (out (B, 1, D), cache).

    A full cache takes the token at slot ``min(pos, cap - 1)`` and masks
    by absolute position; a ring (a windowed layer whose capacity is at
    most its window) at slot ``pos % cap``, every slot within the window,
    the slots not yet written masked until the ring wraps."""
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, x, n_kv_heads)
    posv = torch.full((1,), pos, dtype=torch.long, device=x.device)
    q, k_new = _rope_qk(q, k_new, posv, rope_theta)
    cap = cache["k"].shape[1]
    win = _window(window)
    ring = win is not None and cap <= win
    slot = pos % cap if ring else min(pos, cap - 1)
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    valid = min(pos + 1, cap)
    if ring:
        # rope was applied at write time; no causal mask inside the ring
        o = chunked_attention(
            q, cache["k"], cache["v"], q_positions=posv,
            k_positions=torch.zeros((cap,), dtype=torch.long,
                                    device=x.device),
            causal=False, chunk=chunk, k_valid_len=valid)
    else:
        o = chunked_attention(
            q, cache["k"], cache["v"], q_positions=posv,
            k_positions=torch.arange(cap, device=x.device), causal=True,
            window=win, chunk=chunk, k_valid_len=valid)
    return _out_proj(p, o, x.dtype), cache
