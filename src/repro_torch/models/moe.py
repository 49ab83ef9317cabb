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
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig

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
    G = xt.shape[-2]
    E, K = cfg.num_experts, cfg.top_k
    C = max(1, int(cfg.capacity_factor * G * K / E))
    logits = torch.matmul(xt.to(F32), router.to(F32))
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
    return dispatch.to(xt.dtype), combine, probs, sel


def moe_block(params, x, cfg: MoEConfig,
              group_size: int = GROUP_SIZE
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (K, B, S, D) -> (out (K, B, S, D), aux_loss (K,)); ``params``:
    ``router`` (K, D, E) f32, ``gate``/``up`` (K, E, D, F), ``down``
    (K, E, F, D)."""
    Kc, B, S, D = x.shape
    T = B * S
    G = min(group_size, T)
    if T % G:
        G = T  # single group for awkward (tiny) shapes
    ng = T // G
    xt = x.reshape(Kc, ng, G, D)

    dispatch, combine, probs, sel = _group_dispatch(
        xt, params["router"][:, None], cfg)

    ein = torch.einsum("kgtec,kgtd->kgecd", dispatch, xt)  # (K, ng, E, C, D)
    h = F.silu(torch.einsum("kgecd,kedf->kgecf", ein, params["gate"]).to(F32)
               ).to(x.dtype) * torch.einsum("kgecd,kedf->kgecf", ein,
                                            params["up"])
    eout = torch.einsum("kgecf,kefd->kgecd", h, params["down"])
    out = torch.einsum("kgtec,kgecd->kgtd", combine.to(x.dtype),
                       eout).reshape(Kc, B, S, D)

    # load-balance auxiliary loss (Switch-style), averaged over groups
    E, K = cfg.num_experts, cfg.top_k
    me = torch.mean(probs, dim=(1, 2))  # (Kc, E)
    frac = torch.sum(sel, dim=(1, 2, 3)) / (T * K)
    aux = cfg.router_aux_coef * E * torch.sum(frac * me, dim=-1)
    return out, aux
