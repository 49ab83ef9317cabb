"""Blockwise attention with online softmax (flash-style) in plain torch,
the JAX package's ``models/flash.py``.

Full (S, S) score materialization at long context is a memory
non-starter (B·H·S² f32).  This computes attention in (q_chunk ×
k_chunk) tiles with the running (max, sum, acc) reduction.  When a
gradient is wanted each q-block, and inside it each tile, runs under
``torch.utils.checkpoint``, as JAX checkpoints its ``q_block`` and
``k_step``: the forward keeps each q-block's inputs, a q-block's
recompute keeps its tiles' (max, sum, acc) carries, and only one
tile's scores live at a time, so memory stays O(S·d).

Supports causal masking, sliding windows, GQA and Sq != Sk (cross
attention, ``causal=False``).  Fully-masked (q-block, k-block) tiles
are skipped, so causal/SWA work matches the ideal count within one tile
of slack.  The score products run in float32 on the inputs widened to
float32, as JAX's ``preferred_element_type=float32`` computes them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30
F32 = torch.float32


def _needed(qi: int, ki: int, q_chunk: int, k_chunk: int, causal: bool,
            window: Optional[int]) -> bool:
    """Whether tile (qi, ki) has an unmasked score."""
    needed = True
    if causal:  # any k_pos <= max q_pos in this pair of blocks?
        needed = ki * k_chunk <= qi * q_chunk + q_chunk - 1
    if window is not None:
        needed = needed and (ki * k_chunk + k_chunk - 1
                             > qi * q_chunk - window)
    return needed


def _k_step(m, l, acc, qf, kb, vb, q_pos, k_pos, causal: bool,
            window: Optional[int], scale: float):
    """One needed tile: the running (max, sum, acc) of a q-block after
    the k-block kb/vb (B, k_chunk, KV, hd) at positions ``k_pos``."""
    s = torch.einsum("bqgrh,bkgh->bgrqk", qf, kb.to(F32)) * scale
    msk = torch.zeros((q_pos.shape[0], k_pos.shape[0]), dtype=F32,
                      device=qf.device)
    if causal:
        msk = torch.where(k_pos[None, :] > q_pos[:, None], NEG_INF, msk)
    if window is not None:
        msk = torch.where(k_pos[None, :] <= q_pos[:, None] - window,
                          NEG_INF, msk)
    s = s + msk
    new_m = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - new_m[..., None])
    corr = torch.exp(m - new_m)
    l = l * corr + torch.sum(p, dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bgrqk,bkgh->bgrqh", p.to(vb.dtype), vb).to(F32)
    return new_m, l, acc


def _q_block(qb, kr, vr, qi: int, q_chunk: int, k_chunk: int, causal: bool,
             window: Optional[int], scale: float, remat: bool):
    """One q-block: qb (B, q_chunk, KV, rep, hd) against every needed
    k-block of kr/vr (B, nk, k_chunk, KV, hd) -> (B, q_chunk, KV, rep,
    hd) float32.  With ``remat`` each tile runs under ``checkpoint``, as
    JAX checkpoints its ``k_step``: the q-block's recompute keeps the
    tiles' carries, not their (q_chunk, k_chunk) scores."""
    B, _, KV, rep, hd = qb.shape
    dev = qb.device
    q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)
    m = torch.full((B, KV, rep, q_chunk), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((B, KV, rep, q_chunk), dtype=F32, device=dev)
    acc = torch.zeros((B, KV, rep, q_chunk, hd), dtype=F32, device=dev)
    qf = qb.to(F32)
    for ki in range(kr.shape[1]):
        if not _needed(qi, ki, q_chunk, k_chunk, causal, window):
            continue
        k_pos = ki * k_chunk + torch.arange(k_chunk, device=dev)
        args = (m, l, acc, qf, kr[:, ki], vr[:, ki], q_pos, k_pos, causal,
                window, scale)
        m, l, acc = (checkpoint(_k_step, *args, use_reentrant=False)
                     if remat else _k_step(*args))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    # (B, KV, rep, q_chunk, hd) -> (B, q_chunk, KV, rep, hd)
    return out.permute(0, 3, 1, 2, 4)


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_chunk: int = 1024,
                        k_chunk: int = 1024):
    """q (B,Sq,H,hd); k,v (B,Sk,KV,hd) -> (B,Sq,H,hd) in q's dtype.

    Sq may differ from Sk (cross-attention; use causal=False there).
    Positions are arange within each side.
    """
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    q_chunk = min(q_chunk, S)
    k_chunk = min(k_chunk, Sk)
    nq, nk = S // q_chunk, Sk // k_chunk
    assert nq * q_chunk == S and nk * k_chunk == Sk, "S must tile evenly"

    qr = q.reshape(B, nq, q_chunk, KV, rep, hd)
    kr = k.reshape(B, nk, k_chunk, KV, hd)
    vr = v.reshape(B, nk, k_chunk, KV, hd)
    scale = hd ** -0.5
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for qi in range(nq):
        args = (qr[:, qi], kr, vr, qi, q_chunk, k_chunk, causal, window,
                scale, remat)
        outs.append(checkpoint(_q_block, *args, use_reentrant=False)
                    if remat else _q_block(*args))
    out = torch.stack(outs, dim=1).reshape(B, S, H, hd)
    return out.to(q.dtype)
