"""Grouped-query attention (the JAX package's ``models/attention.py``):
the training forward, decoding, and the encoder-decoder's cross
attention.

``self_attention`` is the full-sequence attention of training, K
clients at once: each client's projections, then ``finish_qkv`` and
``_sdpa_rows`` over the K*B rows, each with its own client's bias, in
the plain einsum/softmax form the JAX package computes below its
``FLASH_THRESHOLD``; from that sequence length on, the blockwise
online-softmax form of ``models/flash.py``, as in JAX.  ``finish_qkv``
is the bias / head-reshape / qk-norm / rope tail of the projections;
``decode_attend`` writes one token into the KV cache and attends;
``decode_attend_lanes`` does the same with a per-lane (B,) position and
a live mask, for the continuous-batching scheduler.  The cache write is
the one-hot blend ``k * (1 - oh) + oh * k_new``, as in JAX, so each
lane's values equal the single-request path's.
``decode_self_attention`` is one token of one model (no client axis),
as the JAX package's; ``encode_kv`` and ``cross_attention`` take the K
axis as ``self_attention`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from .common import linear, rms_norm, rope

NEG_INF = -1e30
FLASH_THRESHOLD = 4096  # the JAX package's blockwise attention from here


@dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None
    rope_theta: float = 10_000.0
    causal: bool = True


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, C, n_kv, hd)  C = min(seq, window or seq)
    v: torch.Tensor
    pos: torch.Tensor  # () or (B,) int64: next write position


def finish_qkv(params, q, k, v, dims: AttnDims, positions):
    """Bias, head reshape, qk-norm and rope of raw (B, S, K) q/k/v."""
    B, S = q.shape[:2]
    h, kv, hd = dims.n_heads, dims.n_kv, dims.head_dim
    if dims.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, h, hd)
    k = k.reshape(B, S, kv, hd)
    v = v.reshape(B, S, kv, hd)
    if dims.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if positions is not None:
        q = rope(q, positions, dims.rope_theta)
        k = rope(k, positions, dims.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, n_rep: int):
    """q (B,Sq,H,hd); k,v (B,Sk,KV,hd); mask (B,1,Sq,Sk) or None.

    One batch row at a time: each product then has the same shapes
    whatever the batch size, so a lane's values equal the single
    request's (a batched product may sum in another order)."""
    return torch.cat([
        _sdpa_rows(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                   None if mask is None else mask[b:b + 1], n_rep)
        for b in range(q.shape[0])])


def _sdpa_rows(q, k, v, mask, n_rep: int):
    B, Sq, H, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(B, Sq, kv, n_rep, hd)
    logits = torch.einsum("bqgrh,bkgh->bgrqk", qg, k).to(torch.float32)
    logits = logits / (hd ** 0.5)
    if mask is not None:
        logits = logits + mask[:, :, None]  # broadcast over rep dim
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bgrqk,bkgh->bqgrh", probs, v)
    return out.reshape(B, Sq, H, hd)


def self_attention(params, x, dims: AttnDims, positions):
    """Full-sequence self-attention of K clients: ``x`` (K, B, S, D),
    every leaf of ``params`` with a leading K axis, ``positions`` (B, S);
    returns (K, B, S, D).  From ``FLASH_THRESHOLD`` tokens on, the
    blockwise form, which assumes positions == arange, as in JAX."""
    K, B, S, _ = x.shape
    q, k, v = (linear(x, params[w]).reshape(K * B, S, -1)
               for w in ("wq", "wk", "wv"))
    # the K*B rows, each beside its client's bias and norm scales
    rows = {name: params[name].repeat_interleave(B, 0)[:, None]
            for name in ("bq", "bk", "bv") if name in params}
    rows.update({name: params[name].repeat_interleave(B, 0)[:, None, None]
                 for name in ("q_norm", "k_norm") if name in params})
    pos = positions.repeat(K, 1)
    q, k, v = finish_qkv(rows, q, k, v, dims, pos)
    if S >= FLASH_THRESHOLD:
        from .flash import blockwise_attention

        out = blockwise_attention(q, k, v, causal=dims.causal,
                                  window=dims.window)
        return linear(out.reshape(K, B, S, -1), params["wo"])
    qi, ki = pos[:, None, :, None], pos[:, None, None, :]
    mask = torch.zeros((K * B, 1, S, S), dtype=torch.float32, device=x.device)
    if dims.causal:
        mask = torch.where(ki > qi, NEG_INF, mask)
    if dims.window is not None:
        mask = torch.where(ki <= qi - dims.window, NEG_INF, mask)
    out = _sdpa_rows(q, k, v, mask, dims.n_heads // dims.n_kv)
    return linear(out.reshape(K, B, S, -1), params["wo"])


def init_cache(batch: int, seq_len: int, dims: AttnDims, dtype,
               device) -> KVCache:
    c = min(seq_len, dims.window) if dims.window else seq_len
    shape = (batch, c, dims.n_kv, dims.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.zeros((), dtype=torch.int64, device=device))


def _valid(abs_pos, pos, dims: AttnDims):
    valid = (abs_pos <= pos) & (abs_pos >= 0)
    if dims.window is not None:
        valid = valid & (abs_pos > pos - dims.window)
    return valid


def decode_attend(q, k, v, cache: KVCache, dims: AttnDims):
    """Single-token attention: cache write + masked SDPA.

    q/k/v (B, 1, heads, hd) already rope'd.  Returns (out (B, 1, H*hd)
    before ``wo``, new KVCache).
    """
    B = q.shape[0]
    C = cache.k.shape[1]
    pos = cache.pos
    slot = pos % C if dims.window is not None else torch.clamp(pos, max=C - 1)
    slots = torch.arange(C, device=q.device)
    oh = (slots == slot).to(cache.k.dtype)[None, :, None, None]
    new_k = cache.k * (1 - oh) + oh * k
    new_v = cache.v * (1 - oh) + oh * v
    if dims.window is not None:
        cycle = (pos // C) * C
        abs_pos = torch.where(slots <= slot, cycle + slots, cycle - C + slots)
    else:
        abs_pos = slots
    mask = torch.where(_valid(abs_pos, pos, dims), 0.0, NEG_INF).to(
        torch.float32)
    mask = mask[None, None, None, :].expand(B, 1, 1, C)
    out = _sdpa(q, new_k, new_v, mask, dims.n_heads // dims.n_kv)
    return out.reshape(B, 1, -1), KVCache(new_k, new_v, pos + 1)


def decode_attend_lanes(q, k, v, cache: KVCache, dims: AttnDims, live):
    """Per-lane decode attention: ``cache.pos`` is (B,), ``live`` a (B,)
    bool admission mask.  Dead lanes write nothing and hold position;
    a live lane's values equal the single-request path's at the same
    position and KV capacity."""
    B = q.shape[0]
    C = cache.k.shape[1]
    pos = cache.pos
    slot = pos % C if dims.window is not None else torch.clamp(pos, max=C - 1)
    slots = torch.arange(C, device=q.device)[None, :]
    oh = (slots == slot[:, None]) & live[:, None]
    ohf = oh.to(cache.k.dtype)[:, :, None, None]
    new_k = cache.k * (1 - ohf) + ohf * k
    new_v = cache.v * (1 - ohf) + ohf * v
    if dims.window is not None:
        cycle = ((pos // C) * C)[:, None]
        abs_pos = torch.where(slots <= slot[:, None], cycle + slots,
                              cycle - C + slots)
    else:
        abs_pos = slots.expand(B, C)
    valid = _valid(abs_pos, pos[:, None], dims)
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    out = _sdpa(q, new_k, new_v, mask[:, None, None, :],
                dims.n_heads // dims.n_kv)
    new_pos = torch.where(live, pos + 1, pos)
    return out.reshape(B, 1, -1), KVCache(new_k, new_v, new_pos)


def decode_self_attention(params, x, cache: KVCache, dims: AttnDims):
    """One-token decode of one model: x (B, 1, d), leaves without a
    client axis.  Ring-buffer write under SWA."""
    B = x.shape[0]
    positions = cache.pos.expand(B, 1)
    q, k, v = (x @ params[w] for w in ("wq", "wk", "wv"))
    q, k, v = finish_qkv(params, q, k, v, dims, positions)
    out, new_cache = decode_attend(q, k, v, cache, dims)
    return out @ params["wo"], new_cache


def encode_kv(params, enc_out, dims: AttnDims):
    """K clients' cross-attention keys and values: enc_out (K, B, Se, D)
    -> k, v (K, B, Se, n_kv, hd)."""
    K, B, Se, _ = enc_out.shape
    k = linear(enc_out, params["wk"]).reshape(K, B, Se, dims.n_kv,
                                              dims.head_dim)
    v = linear(enc_out, params["wv"]).reshape(K, B, Se, dims.n_kv,
                                              dims.head_dim)
    return k, v


def cross_attention(params, x, enc_k, enc_v, dims: AttnDims, enc_mask=None):
    """Decoder->encoder attention of K clients: x (K, B, S, D), enc_k/v
    (K, B, Se, KV, hd) precomputed, ``enc_mask`` (K*B, Se) bool or None.
    No rope on q.  The blockwise form under JAX's condition: a side of
    ``FLASH_THRESHOLD`` tokens or more, no mask, both sides multiples
    of 1024."""
    K, B, S, _ = x.shape
    Se = enc_k.shape[2]
    q = linear(x, params["wq"]).reshape(K * B, S, dims.n_heads,
                                        dims.head_dim)
    ek = enc_k.reshape(K * B, Se, dims.n_kv, dims.head_dim)
    ev = enc_v.reshape(K * B, Se, dims.n_kv, dims.head_dim)
    if (max(S, Se) >= FLASH_THRESHOLD and enc_mask is None
            and S % 1024 == 0 and Se % 1024 == 0):
        from .flash import blockwise_attention

        out = blockwise_attention(q, ek, ev, causal=False)
        return linear(out.reshape(K, B, S, -1), params["wo"])
    mask = None
    if enc_mask is not None:
        mask = torch.where(enc_mask[:, None, None, :], 0.0, NEG_INF).to(
            torch.float32)
    out = _sdpa_rows(q, ek, ev, mask, dims.n_heads // dims.n_kv)
    return linear(out.reshape(K, B, S, -1), params["wo"])
