"""Shared layer primitives (the JAX package's ``models/common.py``).

Weights are stored ``(..., in, out)``; norms, the SwiGLU gate and the
cross-entropy compute in float32.  Training carries a leading client
axis K on every parameter: ``linear`` multiplies a (K, ..., in)
activation by a (K, in, out) weight as one batched product, the
product the JAX package leaves to XLA under ``vmap``.  The JAX
package's ``grouped_scan`` (a scan over layers with nested remat) is a
plain loop over layers here: remat changes memory, not values.

Partitioned consumers.  On a model axis the round hands a sharded leaf
over as this rank's ``comm.shardmap.Block`` (GSPMD's partitioned
consumers behind JAX's ``with_sharding_constraint``).  A column block
(the output axis split: ``wq``, ``wk``, ``wv``, ``gate``, ``up``,
``lm_head``) takes the replicated input through ``copy_to_model`` and
gives its block of the output columns; a row block (the input axis:
``wo``, ``down``) takes its block of the input and its partial products
meet in one all-reduce (``reduce_from_model``), in the activation's
dtype.  ``swiglu`` pairs them Megatron's way when they line up;
``project`` is the consumer of any placement, whole activation in and
out, which gathers (or splits) the activation and never the weight.
``cross_entropy(vocab_axis=)`` is the vocab-parallel CE of logits whose
vocabulary columns are split: the max, the sum of exponentials and the
target's logit each meet in one all-reduce.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..comm.shardmap import (Block, copy_to_model, gather_from_model,
                             max_over_model, reduce_from_model,
                             scatter_to_model)

CE_CHUNK = 8192  # tokens per CE chunk (the JAX package's)
# the leaves the partitioned consumers take as matrices, by the last
# component of their path: a whole gather of one of these is what the
# model axis exists to avoid
MATRIX_LEAVES = ("embed", "dec_embed", "lm_head", "wq", "wk", "wv", "wo",
                 "gate", "up", "down", "router", "in_proj", "out_proj",
                 "kernel")


def matrix_gathers(gathered) -> int:
    """Whole gathers of matrix leaves in a {path: gathers} count
    (``comm.shardmap.GATHERED``).  The SSM's depthwise conv taps
    (``conv_w``, ``conv_b``; 3-D and zampled at full width) count as
    small leaves, as the norm scales do: a rank needs its heads' ``x``
    channels beside the ``B`` and ``C`` channels every head shares,
    which no contiguous block of ``conv_dim`` holds, and they weigh
    ``conv_width + 1`` weights a channel a layer."""
    return sum(n for p, n in gathered.items()
               if p.rsplit("/", 1)[-1] in MATRIX_LEAVES)


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


def model_input(x: torch.Tensor, ws):
    """``x`` through ``copy_to_model`` once for every column block among
    ``ws`` (their input cotangents then meet in one all-reduce), or None
    when there is none."""
    cols = [w for w in ws if isinstance(w, Block) and w.cols]
    return copy_to_model(x, cols[0].axis) if cols else None


def project(x: torch.Tensor, w, xin=None) -> torch.Tensor:
    """``linear(x, w)`` for a replicated activation ``x`` and a leaf in
    any placement, the whole output on every rank: a column block's
    output columns gathered (from ``xin``, ``model_input``'s, when
    given), a row block's partial products from ``x``'s matching block
    summed."""
    if not isinstance(w, Block):
        return linear(x, w)
    if w.cols:
        xin = copy_to_model(x, w.axis) if xin is None else xin
        return gather_from_model(linear(xin, w.t), -1, w.axis)
    if w.rows:
        return reduce_from_model(
            linear(scatter_to_model(x, -1, w.axis), w.t), w.axis)
    raise ValueError(f"{w.path!r}: a block split on dim {w.dim} of "
                     f"{w.t.ndim} is no linear's weight")


def lined_up(*ws, pattern: str):
    """The model AxisGroup when every ``ws`` is a block on one axis,
    column (``c``) or row (``r``) as ``pattern`` spells, else None."""
    if not all(isinstance(w, Block) for w in ws):
        return None
    axis = ws[0].axis
    for w, kind in zip(ws, pattern):
        if w.axis != axis or not (w.cols if kind == "c" else w.rows):
            return None
    return axis


def _glu(g: torch.Tensor, u: torch.Tensor, dtype) -> torch.Tensor:
    return F.silu(g.to(torch.float32)).to(dtype) * u


def swiglu(x, gate_w, up_w, down_w):
    """SwiGLU MLP.  Column blocks of ``gate``/``up`` beside a row block of
    ``down`` on one axis run Megatron's way (one all-reduce forward,
    one backward); any other leaves through ``project``."""
    ws = (gate_w, up_w, down_w)
    axis = lined_up(*ws, pattern="ccr")
    if axis is not None:
        xin = copy_to_model(x, axis)
        h = _glu(linear(xin, gate_w.t), linear(xin, up_w.t), x.dtype)
        return reduce_from_model(linear(h, down_w.t), axis)
    xin = model_input(x, ws)
    h = _glu(project(x, gate_w, xin), project(x, up_w, xin), x.dtype)
    return project(h, down_w)


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
                  lead: int = 0, vocab_axis=None) -> torch.Tensor:
    """Mean token CE in f32 over all but the first ``lead`` axes (one
    mean per client for ``lead=1``).  Chunks of CE_CHUNK tokens are
    summed one by one and then together, as the JAX package does when a
    client has more tokens than that.  With ``vocab_axis`` (a model
    AxisGroup) ``logits`` holds this rank's block of the vocabulary
    columns, ``[index * Vb, (index + 1) * Vb)``."""
    head = labels.shape[:lead]
    T = math.prod(labels.shape[lead:])
    V = logits.shape[-1]
    lf = logits.reshape(*head, T, V)
    ll = labels.reshape(*head, T)
    if T <= CE_CHUNK:
        return _ce_body(lf, ll, ignore=ignore, num_classes=num_classes,
                        axis=vocab_axis)
    nc = -(-T // CE_CHUNK)
    pad = nc * CE_CHUNK - T
    lf = F.pad(lf, (0, 0, 0, pad)).reshape(*head, nc, CE_CHUNK, V)
    ll = F.pad(ll, (0, pad), value=ignore).reshape(*head, nc, CE_CHUNK)
    sums = _ce_body(lf, ll, ignore=ignore, num_classes=num_classes,
                    reduce="sum", axis=vocab_axis)
    counts = (ll != ignore).to(torch.float32).sum(-1)
    return sums.sum(-1) / torch.clamp(counts.sum(-1), min=1.0)


def _ce_body(logits, labels, *, ignore: int = -100, num_classes: int = 0,
             reduce: str = "mean", axis=None):
    """CE over the last token axis of (..., T, V) logits in f32: the
    target's log-probability by a masked sum over V, and vocabulary
    padding (columns >= ``num_classes``) out of the partition function.
    On a vocabulary block (``axis``) the columns are numbered globally,
    and the max (no gradient, as it cancels), the sum of exponentials
    and the target's logit meet over the axis."""
    logits = logits.to(torch.float32)
    vb = logits.shape[-1]
    vid = torch.arange(vb, device=logits.device)
    if axis is not None:
        vid = vid + axis.index * vb
    if num_classes and num_classes < vb * (1 if axis is None else axis.size):
        logits = torch.where(vid < num_classes, logits,
                             torch.tensor(-1e30, device=logits.device))
    m = torch.amax(logits, dim=-1, keepdim=True)
    if axis is not None:
        m = max_over_model(m, axis)
    se = torch.sum(torch.exp(logits - m), dim=-1)
    ll = torch.sum(torch.where(vid == labels[..., None].to(vid.dtype),
                               logits, torch.zeros((), device=logits.device)),
                   dim=-1)
    if axis is not None:
        se = reduce_from_model(se, axis)
        ll = reduce_from_model(ll, axis)
    lse = m[..., 0] + torch.log(se)
    valid = (labels != ignore).to(torch.float32)
    total = torch.sum((lse - ll) * valid, dim=-1)
    if reduce == "sum":
        return total
    return total / torch.clamp(torch.sum(valid, dim=-1), min=1.0)
