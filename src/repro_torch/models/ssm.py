"""Mamba2 block — SSD (state-space duality) chunked form [arXiv:2405.21060]
(the JAX package's ``models/ssm.py``).

Training runs the block-decomposed dual form: intra-chunk terms are
batched products, the inter-chunk state a short loop over chunk
summaries that emits the state before each chunk.  Decode is the O(1)
recurrent update on a constant-size ``(H, P, N)`` state.

Layout per layer (every leaf stacked on a leading L axis in the model):
  in_proj  (D, 2·d_inner + 2·G·N + H)   -> [z | xBC | dt]
  conv_w   (conv_width, conv_dim)        depthwise causal,
                                         conv_dim = d_inner + 2·G·N
  conv_b   (conv_dim,)
  A_log, D, dt_bias   (H,)               float32 whatever the model's dtype
  norm     (d_inner,)                    gated RMSNorm
  out_proj (d_inner, D)

As everywhere in the port's training forward, every parameter leaf
carries a leading client axis K and activations are (K, B, S, D); the
K·B rows then run the SSD as one batch, each row beside its client's
``A_log``, ``D`` and ``dt_bias``.  The casts sit where the JAX block
puts them (the conv output through float32 and back, ``dt`` in
float32, ``y`` back to the input dtype before the gated norm): at bf16
these rounding points decide the numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import SSMConfig
from .common import linear, rms_norm

F32 = torch.float32


class SSMDims(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int
    headdim: int
    d_state: int
    n_groups: int
    conv_width: int
    chunk: int


def ssm_dims(d_model: int, cfg: SSMConfig) -> SSMDims:
    d_inner = cfg.expand * d_model
    return SSMDims(
        d_model=d_model,
        d_inner=d_inner,
        n_heads=d_inner // cfg.headdim,
        headdim=cfg.headdim,
        d_state=cfg.d_state,
        n_groups=cfg.n_groups,
        conv_width=cfg.conv_width,
        chunk=cfg.chunk,
    )


def conv_dim(dims: SSMDims) -> int:
    return dims.d_inner + 2 * dims.n_groups * dims.d_state


def in_proj_dim(dims: SSMDims) -> int:
    return 2 * dims.d_inner + 2 * dims.n_groups * dims.d_state + dims.n_heads


def ssm_param_shapes(dims: SSMDims, stack: int = 0) -> dict:
    """{name: (shape, float32?)} of one block's leaves (``stack`` > 0
    adds the leading layer axis); the float32 leaves are the JAX
    package's ``A_log``, ``D`` and ``dt_bias``."""
    def shp(*s):
        return (stack, *s) if stack else s

    H, cd = dims.n_heads, conv_dim(dims)
    return {
        "in_proj": (shp(dims.d_model, in_proj_dim(dims)), False),
        "conv_w": (shp(dims.conv_width, cd), False),
        "conv_b": (shp(cd), False),
        "A_log": (shp(H), True),
        "D": (shp(H), True),
        "dt_bias": (shp(H), True),
        "norm": (shp(dims.d_inner), False),
        "out_proj": (shp(dims.d_inner, dims.d_model), False),
    }


class SSMCache(NamedTuple):
    conv: torch.Tensor  # (B, conv_width-1, conv_dim)
    state: torch.Tensor  # (B, H, P, N) f32


def init_ssm_cache(batch: int, dims: SSMDims, dtype, device) -> SSMCache:
    return SSMCache(
        conv=torch.zeros((batch, dims.conv_width - 1, conv_dim(dims)),
                         dtype=dtype, device=device),
        state=torch.zeros((batch, dims.n_heads, dims.headdim, dims.d_state),
                          dtype=F32, device=device),
    )


def _per_client(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (K, C) leaf beside a (K, ..., C) activation."""
    return t.reshape(t.shape[0], *([1] * (x.ndim - 2)), t.shape[-1])


def _causal_conv(x, w, b):
    """Depthwise causal conv. x (K,B,S,C); w (K,W,C); b (K,C).  The
    taps summed in the input dtype, in the JAX block's order."""
    W = w.shape[1]
    S = x.shape[2]
    xp = F.pad(x, (0, 0, W - 1, 0))
    acc = None
    for k in range(W):
        term = xp[:, :, k:k + S, :] * w[:, k][:, None, None, :]
        acc = term if acc is None else acc + term
    return acc + b[:, None, None, :]


def _split_proj(zxbcdt, dims: SSMDims):
    di, gn = dims.d_inner, dims.n_groups * dims.d_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    return z, xBC, dt


def _split_xbc(xBC, dims: SSMDims):
    di, gn = dims.d_inner, dims.n_groups * dims.d_state
    x = xBC[..., :di]
    Bmat = xBC[..., di:di + gn]
    Cmat = xBC[..., di + gn:]
    return x, Bmat, Cmat


def _group_to_heads(mat, dims: SSMDims):
    """(..., G*N) -> (..., H, N) broadcasting each group to its heads."""
    g = mat.reshape(*mat.shape[:-1], dims.n_groups, dims.d_state)
    return torch.repeat_interleave(g, dims.n_heads // dims.n_groups, dim=-2)


def ssm_block(params, u, dims: SSMDims) -> torch.Tensor:
    """Full-sequence SSD of K clients: u (K,B,S,D) -> (K,B,S,D), every
    leaf of ``params`` with a leading K axis.

    The JAX block's multi-operand einsums are contracted pairwise in an
    order that never forms a (rows, chunk, l, s, h, p) tensor: the
    (l, s) weights ``scores * L * dt_s`` first, then one product over
    s with x; the chunk states weight B by ``decay * dt`` before the
    product over s with x; the off-diagonal term scales C by
    ``exp(cum)`` before the product with the carried states.  At the
    full-width mamba2-1.3b step (K·B = 16 rows, Lc = 128, H = 64) each
    (rows, nc, Lc, Lc, H) f32 tensor is 67 MB a layer; a six-axis one
    would be 4.3 GB."""
    K, B, S, D = u.shape
    Lc = min(dims.chunk, S)
    assert S % Lc == 0, f"seq {S} must tile into chunks of {Lc}"
    nc = S // Lc
    H, P, N = dims.n_heads, dims.headdim, dims.d_state
    R = K * B

    zxbcdt = linear(u, params["in_proj"])
    z, xBC, dt = _split_proj(zxbcdt, dims)
    xBC = F.silu(_causal_conv(xBC, params["conv_w"], params["conv_b"]).to(F32)
                 ).to(u.dtype)
    x, Bm, Cm = _split_xbc(xBC, dims)
    # (K,B,S,H)
    dt = F.softplus(dt.to(F32) + _per_client(params["dt_bias"], dt))
    A = -torch.exp(params["A_log"])  # (K,H)

    xh = x.reshape(R, S, H, P)
    Bh = _group_to_heads(Bm, dims).reshape(R, S, H, N)
    Ch = _group_to_heads(Cm, dims).reshape(R, S, H, N)

    a = (dt * _per_client(A, dt)).reshape(R, nc, Lc, H)  # log-decay per step
    dtc = dt.reshape(R, nc, Lc, H)
    xc = xh.reshape(R, nc, Lc, H, P).to(F32)
    Bc = Bh.reshape(R, nc, Lc, H, N).to(F32)
    Cc = Ch.reshape(R, nc, Lc, H, N).to(F32)

    cum = torch.cumsum(a, dim=2)  # (R,nc,Lc,H)
    # intra-chunk: L[i,j] = exp(cum_i - cum_j) for i >= j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (R,nc,Lc,Lc,H)
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=u.device))
    # exp of the kept entries only: above the diagonal seg is a growth
    # that overflows to inf once a chunk decays by more than e^88, and
    # where()'s gradient (0 there) times exp's (inf) is NaN
    zero = torch.zeros((), dtype=F32, device=u.device)
    lower = tri[None, None, :, :, None]
    Lmat = torch.where(lower, torch.exp(torch.where(lower, seg, zero)), zero)
    scores = torch.einsum("bclhn,bcshn->bclsh", Cc, Bc)
    wts = scores * Lmat * dtc[:, :, None, :, :]
    del seg, Lmat, scores
    y_diag = torch.einsum("bclsh,bcshp->bclhp", wts, xc)

    # chunk state summaries: S_c = sum_s exp(cum_end - cum_s) dt_s B_s x_s^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (R,nc,Lc,H)
    states = torch.einsum("bcshn,bcshp->bchpn",
                          (decay_to_end * dtc)[..., None] * Bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (R,nc,H)

    h = torch.zeros((R, H, P, N), dtype=F32, device=u.device)
    h_prev = []
    for c in range(nc):  # emit the state BEFORE each chunk
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (R,nc,H,P,N)

    y_off = torch.einsum("bclhn,bchpn->bclhp", Cc * torch.exp(cum)[..., None],
                         h_prev)

    y = (y_diag + y_off).reshape(K, B, S, H, P)
    y = y + params["D"][:, None, None, :, None] * xh.reshape(
        K, B, S, H, P).to(F32)
    y = y.reshape(K, B, S, dims.d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z.to(F32)).to(u.dtype),
                 _per_client(params["norm"], y))
    return linear(y, params["out_proj"])


def ssm_decode_step(params, u, cache: SSMCache, dims: SSMDims
                    ) -> Tuple[torch.Tensor, SSMCache]:
    """One-token recurrent update of K clients: u (K,B,1,D), the cache's
    conv (K,B,W-1,C) and state (K,B,H,P,N)."""
    K, B = u.shape[:2]
    H, P, N = dims.n_heads, dims.headdim, dims.d_state

    zxbcdt = linear(u, params["in_proj"])[:, :, 0]
    z, xBC, dt = _split_proj(zxbcdt, dims)
    conv_hist = torch.cat([cache.conv, xBC[:, :, None, :]], dim=2)
    conv_out = (torch.einsum("kbwc,kwc->kbc", conv_hist.to(F32),
                             params["conv_w"].to(F32))
                + params["conv_b"].to(F32)[:, None, :])
    xBC = F.silu(conv_out).to(u.dtype)
    x, Bm, Cm = _split_xbc(xBC, dims)
    dt = F.softplus(dt.to(F32) + params["dt_bias"][:, None, :])  # (K,B,H)
    A = -torch.exp(params["A_log"])

    xh = x.reshape(K, B, H, P).to(F32)
    Bh = _group_to_heads(Bm, dims).to(F32)  # (K,B,H,N)
    Ch = _group_to_heads(Cm, dims).to(F32)

    dA = torch.exp(dt * A[:, None, :])  # (K,B,H)
    state = (cache.state * dA[..., None, None]
             + xh[..., :, None] * (dt[..., None] * Bh)[..., None, :])
    y = (torch.einsum("kbhpn,kbhn->kbhp", state, Ch)
         + params["D"][:, None, :, None] * xh)
    y = y.reshape(K, B, dims.d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z.to(F32)).to(u.dtype), params["norm"][:, None, :])
    out = linear(y, params["out_proj"])[:, :, None, :]
    new_cache = SSMCache(conv=conv_hist[:, :, 1:, :].to(cache.conv.dtype),
                         state=state)
    return out, new_cache
