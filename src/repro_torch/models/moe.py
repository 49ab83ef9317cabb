"""Mixture-of-Experts block (OLMoE 64e/top-8, Mixtral 8e/top-2), the JAX
package's ``models/moe.py``.

GShard-style *group-local* capacity dispatch: tokens are processed in
groups of ``GROUP_SIZE``; within each group, tokens pick their top-k
experts and a (G, E, C) one-hot dispatch tensor routes them, with
C = max(1, int(capacity_factor·G·k/E)).  The expert FFNs run as one
batched product over the expert axis.

The integer part equals JAX's: the selected experts, each pick's buffer
slot (a running count per expert over the group's (token, pick) order)
and whether it fits.  ``jax.lax.top_k`` takes the lower index among
equal probabilities; ``torch.topk`` promises no order among ties, so
the picks come from a stable descending sort instead.

As in the port's training forward, every leaf carries a leading client
axis K and activations are (K, B, S, D); the aux loss comes back per
client, (K,).

On a model axis (``comm.shardmap.Block`` leaves) the block takes one of
two placements, as ``launch.sharding.param_spec`` gives them:
 - experts split on E (the expert axis divides the model axis): each
   rank its experts' router columns, whose f32 logits are gathered,
   its experts' slice of the dispatch and of the combine, and its
   stacked ``gate``/``up``/``down``; the partial outputs meet in one
   all-reduce;
 - experts split on F: ``gate``/``up`` column blocks and ``down`` a row
   block inside every expert (the SwiGLU pairing), the router a row
   block over D whose partial f32 logits meet in one all-reduce; the
   combined partial outputs meet in one all-reduce.
The softmax, the top-k, the capacity slots, the dispatch, the combine
and the aux loss come from the whole logits, which every rank of the
model group holds by the same bits, so they are bit-identical across
it.  The replicated input enters through ``copy_to_model`` (its
cotangent's parts summed); the replicated combine reaches rank-local
work through ``scatter_to_model`` (experts on E: each rank uses its own
slice, whose cotangents are joined) or ``copy_to_model`` (experts on F:
every rank multiplies all of it into a partial output, whose
cotangents are summed).  Any other placement raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..comm.shardmap import (Block, copy_to_model, gather_from_model,
                             reduce_from_model, scatter_to_model)
from ..configs.base import MoEConfig
from .common import lined_up

GROUP_SIZE = 2048
F32 = torch.float32


def top_k_lower_first(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, equal
    values in ascending index order (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _group_dispatch(xt, router, cfg: MoEConfig):
    """xt (..., G, D), router (..., D, E) broadcastable -> (dispatch
    (..., G, E, C) in xt's dtype, combine (..., G, E, C) f32, probs
    (..., G, E), sel (..., G, k, E))."""
    logits = torch.matmul(xt.to(F32), router.to(F32))
    return _dispatch(logits, cfg, xt.dtype)


def _dispatch(logits, cfg: MoEConfig, dtype):
    """``_group_dispatch`` from the router's f32 logits (..., G, E)."""
    G = logits.shape[-2]
    E, K = cfg.num_experts, cfg.top_k
    C = max(1, int(cfg.capacity_factor * G * K / E))
    probs = torch.softmax(logits, dim=-1)  # (..., G, E)
    gate_vals, gate_idx = top_k_lower_first(probs, K)  # (..., G, K)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    sel = F.one_hot(gate_idx, E).to(F32)  # (..., G, K, E)
    lead = sel.shape[:-3]
    pos_in_e = (torch.cumsum(sel.reshape(*lead, G * K, E), dim=-2) - 1.0
                ).reshape(*lead, G, K, E)
    pos = torch.sum(pos_in_e * sel, dim=-1)  # (..., G, K) buffer slot per pick
    keep = pos < C
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    pos_oh = F.one_hot(torch.where(keep, pos, torch.full_like(pos, C)).to(
        torch.int64), C + 1).to(F32)[..., :C]  # (..., G, K, C)
    dispatch = torch.einsum("...tke,...tkc->...tec", sel, pos_oh)
    combine = torch.einsum("...tke,...tkc->...tec", sel,
                           pos_oh * gate_vals[..., None])
    return dispatch.to(dtype), combine, probs, sel


def _placement(params):
    """("experts" or "ffn", model AxisGroup) for expert stacks split on E
    or on F, (None, None) for whole ones; any other placement raises,
    naming the leaf and the split."""
    ws = [params[n] for n in ("gate", "up", "down")]
    if not any(isinstance(w, Block) for w in ws):
        return None, None
    if all(isinstance(w, Block) for w in ws):
        axis = ws[0].axis
        if all(w.axis == axis and w.dim == w.t.ndim - 3 for w in ws):
            return "experts", axis
        if lined_up(*ws, pattern="ccr") is not None:
            return "ffn", axis
    w = next(w for w in ws if isinstance(w, Block))
    raise ValueError(
        f"{w.path!r}: expert stacks split on dim {w.dim} of {w.t.ndim} "
        f"over a model axis of {w.axis.size} (gate/up/down "
        f"{[w.dim if isinstance(w, Block) else None for w in ws]}): the MoE "
        "block takes experts split on E, or on F (gate/up columns, down "
        "rows)")


def _router_logits(xt, router, xin):
    """The router's f32 logits (K, ng, G, E), whole on every rank of a
    model group by the same bits: a column block's experts' logits
    from ``xin`` (``copy_to_model``'s input), gathered; a row block's
    partial logits over its D block, summed; a whole router's
    product."""
    if not isinstance(router, Block):
        return torch.matmul(xt.to(F32), router[:, None].to(F32))
    r = router.t[:, None].to(F32)
    if router.cols:
        xin = copy_to_model(xt, router.axis) if xin is None else xin
        return gather_from_model(torch.matmul(xin.to(F32), r), -1,
                                 router.axis)
    if router.rows:
        return reduce_from_model(torch.matmul(
            scatter_to_model(xt, -1, router.axis).to(F32), r), router.axis)
    raise ValueError(f"{router.path!r}: a router split on dim {router.dim} "
                     f"of {router.t.ndim}")


def _local(w):
    """A leaf's tensor: this rank's block of it, or the whole leaf."""
    return w.t if isinstance(w, Block) else w


def _experts(ein, gate, up, down, dtype):
    """The stacked expert FFNs: ein (K, ng, E, C, D) -> (K, ng, E, C, D)."""
    h = F.silu(torch.einsum("kgecd,kedf->kgecf", ein, gate).to(F32)
               ).to(dtype) * torch.einsum("kgecd,kedf->kgecf", ein, up)
    return torch.einsum("kgecf,kefd->kgecd", h, down)


def moe_block(params, x, cfg: MoEConfig,
              group_size: int = GROUP_SIZE
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (K, B, S, D) -> (out (K, B, S, D), aux_loss (K,)); ``params``:
    ``router`` (K, D, E) f32, ``gate``/``up`` (K, E, D, F), ``down``
    (K, E, F, D), tensors or, on a model axis, blocks (the module's
    note)."""
    Kc, B, S, D = x.shape
    T = B * S
    G = min(group_size, T)
    if T % G:
        G = T  # single group for awkward (tiny) shapes
    ng = T // G
    xt = x.reshape(Kc, ng, G, D)

    split, axis = _placement(params)
    xin = copy_to_model(xt, axis)  # xt itself for whole experts
    dispatch, combine, probs, sel = _dispatch(
        _router_logits(xt, params["router"], None if split is None else xin),
        cfg, x.dtype)
    gate, up, down = (_local(params[n]) for n in ("gate", "up", "down"))
    disp, comb = dispatch, combine.to(x.dtype)
    if split == "experts":  # this rank's experts' slots
        e = gate.shape[1]
        disp = dispatch.narrow(-2, axis.index * e, e)
        comb = scatter_to_model(comb, -2, axis)
    else:  # every expert's F block (partial outputs), or whole experts
        comb = copy_to_model(comb, axis)
    ein = torch.einsum("kgtec,kgtd->kgecd", disp, xin)  # (K,ng,E,C,D)
    out = reduce_from_model(torch.einsum(
        "kgtec,kgecd->kgtd", comb, _experts(ein, gate, up, down, x.dtype)),
        axis)
    out = out.reshape(Kc, B, S, D)

    # load-balance auxiliary loss (Switch-style), averaged over groups
    E, K = cfg.num_experts, cfg.top_k
    me = torch.mean(probs, dim=(1, 2))  # (Kc, E)
    frac = torch.sum(sel, dim=(1, 2, 3)) / (T * K)
    aux = cfg.router_aux_coef * E * torch.sum(frac * me, dim=-1)
    return out, aux
