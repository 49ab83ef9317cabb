"""Shared layer primitives (the JAX package's ``models/common.py``).

Weights are stored ``(..., in, out)``; norms, the SwiGLU gate and the
cross-entropy compute in float32.  Training carries a leading client
axis K on every parameter: ``linear`` multiplies a (K, ..., in)
activation by a (K, in, out) weight as one batched product, the
product the JAX package leaves to XLA under ``vmap``.  The JAX
package's ``grouped_scan`` (a scan over layers with nested remat) is a
plain loop over layers here: remat changes memory, not values.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

CE_CHUNK = 8192  # tokens per CE chunk (the JAX package's)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True)
                        + eps)
    return (x * scale.to(torch.float32)).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    ar = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-math.log(theta) * ar / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w over the last axis; a 3-D w (K, in, out) takes x (K, ...,
    in) client by client as one batched product."""
    if w.ndim == 2:
        return x @ w
    k = w.shape[0]
    y = torch.bmm(x.reshape(k, -1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def swiglu(x, gate_w, up_w, down_w):
    g = linear(x, gate_w)
    u = linear(x, up_w)
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return linear(h, down_w)


def _bias(b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A bias for ``y``: (out,), or (K, out) beside a (K, ..., out)
    activation, one row a client."""
    if b.ndim == 1:
        return b
    return b.reshape(b.shape[0], *([1] * (y.ndim - 2)), b.shape[-1])


def gelu_mlp(x, up_w, up_b, down_w, down_b):
    """GELU (tanh form, ``jax.nn.gelu``'s default) MLP with biases, the
    activation in float32."""
    h = linear(x, up_w)
    h = h + _bias(up_b, h)
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    y = linear(h, down_w)
    return y + _bias(down_b, y)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  ignore: int = -100, num_classes: int = 0,
                  lead: int = 0) -> torch.Tensor:
    """Mean token CE in f32 over all but the first ``lead`` axes (one
    mean per client for ``lead=1``).  Chunks of CE_CHUNK tokens are
    summed one by one and then together, as the JAX package does when a
    client has more tokens than that."""
    head = labels.shape[:lead]
    T = math.prod(labels.shape[lead:])
    V = logits.shape[-1]
    lf = logits.reshape(*head, T, V)
    ll = labels.reshape(*head, T)
    if T <= CE_CHUNK:
        return _ce_body(lf, ll, ignore=ignore, num_classes=num_classes)
    nc = -(-T // CE_CHUNK)
    pad = nc * CE_CHUNK - T
    lf = F.pad(lf, (0, 0, 0, pad)).reshape(*head, nc, CE_CHUNK, V)
    ll = F.pad(ll, (0, pad), value=ignore).reshape(*head, nc, CE_CHUNK)
    sums = _ce_body(lf, ll, ignore=ignore, num_classes=num_classes,
                    reduce="sum")
    counts = (ll != ignore).to(torch.float32).sum(-1)
    return sums.sum(-1) / torch.clamp(counts.sum(-1), min=1.0)


def _ce_body(logits, labels, *, ignore: int = -100, num_classes: int = 0,
             reduce: str = "mean"):
    """CE over the last token axis of (..., T, V) logits in f32: the
    target's log-probability by a masked sum over V, and vocabulary
    padding (columns >= ``num_classes``) out of the partition function."""
    logits = logits.to(torch.float32)
    vid = torch.arange(logits.shape[-1], device=logits.device)
    if num_classes and num_classes < logits.shape[-1]:
        logits = torch.where(vid < num_classes, logits,
                             torch.tensor(-1e30, device=logits.device))
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m), dim=-1))
    ll = torch.sum(torch.where(vid == labels[..., None].to(vid.dtype),
                               logits, torch.zeros((), device=logits.device)),
                   dim=-1)
    valid = (labels != ignore).to(torch.float32)
    total = torch.sum((lse - ll) * valid, dim=-1)
    if reduce == "sum":
        return total
    return total / torch.clamp(torch.sum(valid, dim=-1), min=1.0)
