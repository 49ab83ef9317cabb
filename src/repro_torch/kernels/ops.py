"""The reconstruction ops: training (fused sample-reconstruct, upload
pack) and streaming serve (y = x @ W_g with W_g never materialized).

TRAINING HALF (the JAX package's ``kernels/ops.py:143-811``, what the
federated round and local training need).  ``sample_reconstruct_batched``
is ``W_k = Q Bern(P_k)`` for K stacked clients as a
``torch.autograd.Function``: the forward draws the masks inside the op
(CUDA kernel 8, ``qz_sample_reconstruct_batched_fwd``; kernel 7 at
K=1), the backward is the straight-through ``grad_P = Q^T grad_W``, and
the draw words get no gradient.  The transpose is the one the gate
``REPRO_BWD_PLAN`` names when the backward runs: a transpose plan of
either order (kernel 6; kernel 5, ``qz_reconstruct_bwd_plan``, at K=1),
or the scatter, which regenerates Q and holds no plan (kernel 4,
``qz_reconstruct_batched_bwd``; kernel 2, ``qz_reconstruct_bwd``, at
K=1), the only one whose memory fits full-width LM training.
``reconstruct_batched`` is ``W_k = Q Z_k`` from explicit operands
(masks, or probabilities in continuous mode) with the same backward:
kernel 3 forward (kernel 1, ``qz_reconstruct_fwd``, for the
single-client ``reconstruct``).  With ``qbits`` the operand is the
u8/u16 downlink words, or with ``qpacked`` too a packed codec's (K,
``packed_word_len(n, qbits)``) uint32 lanes, which kernels 7 and 8 read
in their own body, at any window; the op has no gradient.  (The JAX
package sends a window that does not hold whole lanes to its plain
path; the CUDA kernels take every window.)
``sample_pack_batched`` draws the upload and emits wire lanes (kernel
10; a spec with ``window % 32 != 0`` takes the plain path, as the JAX
package's does); ``sample_pack``, one client's upload, is kernel 9 at
any window (the CUDA kernel packs by coordinate, whatever the window).
Impl dispatch: ``"cuda"`` (the kernels) or ``"ref"``
(the plain torch versions below), by the argument, else
``REPRO_RECONSTRUCT_IMPL``, else the tensor's device; ``"cuda"`` on a
CPU tensor raises.  The round calls the batched ops directly: there are
no vmap rules to install.

SERVE HALF.  Every zampled linear of the serving engine calls
``serve_matmul`` (or ``serve_matvec`` at B=1); each regenerates the
group's Q edges, draws the mask bits straight from the encoded score
words, and contracts against the activations.  Impl dispatch:
``"cuda"`` is the CUDA kernel (``kernels.qz_decode``), ``"chunked"``
the plain torch path below.  With no impl given (and no
``REPRO_SERVE_IMPL`` override) a CUDA tensor goes to the kernel and a
CPU tensor to the plain path; ``"cuda"`` on a CPU tensor raises.

CANONICAL CONTRACTION TREE.  The summation order is part of the serve
contract, as in the JAX package (``SERVE_BM = 256``): the flat rows of
the group are cut into (window, bm) blocks, visited in ascending order,
and each block adds to the output the dot of its input rows with its
tile of weights.  For output column ``o`` this reads

    y_o = sum over blocks t, ascending, of
          ( sum over the block's input rows i, ascending, of x_i * W_io )

where each inner sum starts from 0.0, every product and add is rounded
on its own (no FMA), and a block that holds no row of column ``o``
adds nothing.  Cells of the JAX tile that hold no live row contribute
exact zeros there, so both trees give the same values.  Each edge
weight ``sum_k vals_k * bit_k`` also sums in ascending k.  The plain
path and the kernel compute exactly this, so they agree bit for bit,
and a batch row's result does not depend on the batch size.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..comm.bitpack import pack_mask, packed_word_len, unpack_words
from ..core.hashrng import bernoulli_u32
from ..core.qspec import QSpec, row_indices, row_values
from ..core.reconstruct import (_insert_padding_batched, _move_batched,
                                _unmove_batched, plan_apply_batched,
                                reconstruct_batched_ref,
                                scatter_apply_batched)
from ..core.sampling import (as_word, as_words, mask_u32,
                              quant_threshold_u24, sample_mask_hash,
                              sample_mask_qhash, word_values)
from ..core.transpose_plan import resolve_bwd_path

SERVE_BM = 256
VALID_SERVE_IMPLS = ("chunked", "cuda")
VALID_IMPLS = ("ref", "cuda")

# edges regenerated at once by the plain path (bounds its temporaries)
_CHUNK_EDGES = 1 << 22


# ---------------------------------------------------------------------------
# Training half
# ---------------------------------------------------------------------------

def resolve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    """The impl a training op runs: the argument, else
    ``REPRO_RECONSTRUCT_IMPL``, else the kernels for a CUDA tensor and
    the plain path for a CPU one."""
    impl = impl or os.environ.get("REPRO_RECONSTRUCT_IMPL")
    if impl is None:
        return "cuda" if x.is_cuda else "ref"
    if impl not in VALID_IMPLS:
        raise ValueError(f"unknown reconstruction impl {impl!r}; valid "
                         f"impls: {', '.join(VALID_IMPLS)}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("reconstruction impl 'cuda' needs CUDA tensors; "
                         f"got a tensor on {x.device}")
    return impl


def _draw(spec: QSpec, P: torch.Tensor, steps: torch.Tensor, qbits,
          qpacked: bool = False):
    if qbits is None:
        return sample_mask_hash(P, spec.seed, spec.tensor_id, steps)
    if qpacked:  # the per-coordinate words first: JAX ops._sample_one
        P = unpack_words(P, spec.n, qbits)
    return sample_mask_qhash(P, qbits, spec.seed, spec.tensor_id, steps)


def reconstruct_plain(spec: QSpec, Z: torch.Tensor) -> torch.Tensor:
    """The plain torch version of kernels 3 and 1: (K, n) operands ->
    W (K, m) in moved flat order, each row summing its edge value times
    the client's operand in ascending k: ``reconstruct_batched_ref``."""
    return _move_batched(spec, reconstruct_batched_ref(spec, Z))


def sample_reconstruct_plain(spec: QSpec, P: torch.Tensor, steps,
                             qbits: Optional[int] = None,
                             qpacked: bool = False) -> torch.Tensor:
    """The plain torch version of kernels 8 and 7: (K, n) operand (or,
    with ``qpacked``, (K, packed_word_len(n, qbits)) lanes, unpacked to
    words first) + (K,) draw words -> W (K, m) in moved flat order: the
    drawn masks through ``reconstruct_plain``, as the kernel multiplies
    each edge value by the client's drawn bit."""
    steps = as_words(steps, P.device).reshape(-1)
    return reconstruct_plain(spec, _draw(spec, P, steps, qbits, qpacked))


def plan_bwd_plain(spec: QSpec, G: torch.Tensor,
                   order: str = "canonical") -> torch.Tensor:
    """The plain torch version of kernel 6: (K, m) cotangents in moved
    flat order -> (K, n) over the ``order`` transpose plan."""
    return plan_apply_batched(
        spec, _insert_padding_batched(spec, G.to(torch.float32)), order)


def plan_bwd_one_plain(spec: QSpec, g: torch.Tensor,
                       order: str = "canonical") -> torch.Tensor:
    """The plain torch version of kernel 5: one (m,) cotangent in moved
    flat order -> (n,) over the ``order`` transpose plan."""
    return plan_bwd_plain(spec, g[None], order)[0]


def scatter_bwd_plain(spec: QSpec, G: torch.Tensor) -> torch.Tensor:
    """The plain torch version of kernel 4: (K, m) cotangents in moved
    flat order -> (K, n) by the scatter, a chunk of windows at a time,
    no plan held (``core.reconstruct.scatter_apply_batched``)."""
    return scatter_apply_batched(
        spec, _insert_padding_batched(spec, G.to(torch.float32)))


def scatter_bwd_one_plain(spec: QSpec, g: torch.Tensor) -> torch.Tensor:
    """The plain torch version of kernel 2: one (m,) cotangent -> (n,)."""
    return scatter_bwd_plain(spec, g[None])[0]


def sample_pack_plain(spec: QSpec, P: torch.Tensor, steps) -> torch.Tensor:
    """The plain torch version of kernel 10: (K, n) probabilities ->
    (K, ceil(n/32)) upload lanes."""
    steps = as_words(steps, P.device).reshape(-1)
    return pack_mask(sample_mask_hash(P, spec.seed, spec.tensor_id, steps))


def sample_pack_one_plain(spec: QSpec, p: torch.Tensor, step) -> torch.Tensor:
    """The plain torch version of kernel 9: (n,) probabilities and one
    draw word -> (ceil(n/32),) upload lanes."""
    return pack_mask(sample_mask_hash(p, spec.seed, spec.tensor_id,
                                      as_word(step)))


def _fwd_many(spec, P, steps, impl, qbits, single, qpacked=False):
    """Kernels 7/8 (a draw at ``steps``) or 1/3 (``steps`` None: P is
    the explicit operand)."""
    if impl == "ref":
        if steps is None:
            return reconstruct_plain(spec, P)
        return sample_reconstruct_plain(spec, P, steps, qbits, qpacked)
    from . import qz_reconstruct as qr

    if steps is None:
        if single:
            return qr.qz_reconstruct_fwd(spec, P[0])[None]
        return qr.qz_reconstruct_batched_fwd(spec, P)
    if single:
        return qr.qz_sample_reconstruct_fwd(spec, P[0], steps, qbits,
                                            qpacked)[None]
    return qr.qz_sample_reconstruct_batched_fwd(spec, P, steps, qbits,
                                                qpacked)


def _bwd_many(spec, G, impl, single):
    """The transpose the gate names, read when the backward runs: the
    plan of either order on kernel 6 (kernel 5 for one client), or the
    scatter on kernel 4 (kernel 2 for one client)."""
    kind, order = resolve_bwd_path()
    if impl == "ref":
        if kind == "plan":
            return plan_bwd_plain(spec, G, order)
        return scatter_bwd_plain(spec, G)
    from . import qz_reconstruct as qr

    if kind == "plan":
        if single:
            return qr.qz_reconstruct_bwd_plan(spec, G[0], order)[None]
        return qr.qz_reconstruct_batched_bwd_plan(spec, G, order)
    if single:
        return qr.qz_reconstruct_bwd(spec, G[0])[None]
    return qr.qz_reconstruct_batched_bwd(spec, G)


class _Reconstruct(torch.autograd.Function):
    """W = Q Z, or W = Q Bern(P) drawn at ``steps`` (straight-through);
    either way grad = Q^T grad_W."""

    @staticmethod
    def forward(ctx, P, steps, spec, impl, single):
        ctx.spec, ctx.impl, ctx.single = spec, impl, single
        return _fwd_many(spec, P, steps, impl, None, single)

    @staticmethod
    def backward(ctx, gW):
        return (_bwd_many(ctx.spec, gW.contiguous(), ctx.impl, ctx.single),
                None, None, None, None)


def _check_batched(spec, P, what, n=None):
    n = spec.n if n is None else n
    if P.ndim != 2 or P.shape[-1] != n:
        raise ValueError(f"{what} has shape {tuple(P.shape)}, spec "
                         f"expects (K, {n})")


def _sample_reconstruct(spec, P, steps, qbits, qpacked, impl, single):
    if qpacked and qbits is None:
        raise ValueError("qpacked requires qbits (a packed codec width)")
    _check_batched(spec, P, "operand",
                   packed_word_len(spec.n, int(qbits)) if qpacked else None)
    impl = resolve_impl(impl, P)
    steps = as_words(steps, P.device).reshape(-1)
    if qbits is not None:
        W = _fwd_many(spec, P.contiguous(), steps, impl, int(qbits), single,
                      bool(qpacked))
    else:
        W = _Reconstruct.apply(P.to(torch.float32).contiguous(), steps,
                               spec, impl, single)
    return _unmove_batched(spec, W)


def _reconstruct(spec, Z, impl, single):
    _check_batched(spec, Z, "Z")
    impl = resolve_impl(impl, Z)
    W = _Reconstruct.apply(Z.to(torch.float32).contiguous(), None, spec,
                           impl, single)
    return _unmove_batched(spec, W)


def reconstruct_batched(spec: QSpec, Z: torch.Tensor, *,
                        impl: Optional[str] = None) -> torch.Tensor:
    """W_k = Q z^(k) for K stacked clients: Z (K, n) -> (K, *spec.shape)
    f32, differentiable in Z (grad = Q^T grad_W).  Kernel 3 forward,
    kernel 6 backward."""
    return _reconstruct(spec, Z, impl, False)


def reconstruct(spec: QSpec, z: torch.Tensor, *,
                impl: Optional[str] = None) -> torch.Tensor:
    """w = Q z for one operand: (n,) -> spec.shape f32, differentiable
    in z.  Kernel 1 forward, kernel 5 backward."""
    if z.ndim != 1:
        raise ValueError(f"z has shape {tuple(z.shape)}, spec expects "
                         f"({spec.n},)")
    return _reconstruct(spec, z[None], impl, True)[0]


def sample_reconstruct_batched(spec: QSpec, P: torch.Tensor, steps, *,
                               qbits: Optional[int] = None,
                               qpacked: bool = False,
                               impl: Optional[str] = None) -> torch.Tensor:
    """Fused W_k = Q Bern(P_k) for K stacked clients: P (K, n) clipped
    probabilities + (K,) draw words -> (K, *spec.shape) f32.

    Differentiable in P (straight-through); chain through
    ``clip_probs`` for the paper's gate.  With ``qbits`` P is the
    (K, n) u8/u16 word slab and the draw is the threshold compare; with
    ``qpacked`` too it is the (K, packed_word_len(n, qbits)) uint32 lane
    slab of a packed codec."""
    return _sample_reconstruct(spec, P, steps, qbits, qpacked, impl, False)


def sample_reconstruct(spec: QSpec, p: torch.Tensor, step, *,
                       qbits: Optional[int] = None, qpacked: bool = False,
                       impl: Optional[str] = None) -> torch.Tensor:
    """Fused w = Q Bern(p) for one client: (n,) + a draw word ->
    spec.shape f32 (``qbits``/``qpacked`` as for the batched op).
    Kernel 7 (the batched kernel at K=1) forward, kernel 5 backward."""
    return _sample_reconstruct(spec, p[None], step, qbits, qpacked, impl,
                               True)[0]


def sample_pack_batched(spec: QSpec, P: torch.Tensor, steps, *,
                        impl: Optional[str] = None) -> torch.Tensor:
    """Fused upload draw for K clients: P (K, n) probabilities + (K,)
    draw words -> (K, ceil(n/32)) lanes (int64 holding uint32), equal
    to ``pack_mask(sample_mask_hash(P, ...))``.  No gradient."""
    if P.ndim != 2 or P.shape[-1] != spec.n:
        raise ValueError(f"P has shape {tuple(P.shape)}, spec expects "
                         f"(K, {spec.n})")
    impl = resolve_impl(impl, P)
    steps = as_words(steps, P.device).reshape(-1)
    P = P.detach().to(torch.float32).contiguous()
    # the kernel emits whole lanes per window, as the Pallas one does
    if impl == "ref" or spec.window % 32 != 0:
        return sample_pack_plain(spec, P, steps)
    from . import qz_reconstruct

    return qz_reconstruct.qz_sample_pack_batched_fwd(spec, P, steps)


def sample_pack(spec: QSpec, p: torch.Tensor, step: int, *,
                impl: Optional[str] = None) -> torch.Tensor:
    """Fused upload draw for one client: p (n,) + one draw word ->
    (ceil(n/32),) lanes, equal to ``sample_pack_batched``'s row.  Kernel
    9; no gradient."""
    if p.ndim != 1 or p.shape[0] != spec.n:
        raise ValueError(f"p has shape {tuple(p.shape)}, spec expects "
                         f"({spec.n},)")
    impl = resolve_impl(impl, p)
    p = p.detach().to(torch.float32).contiguous()
    if impl == "ref":
        return sample_pack_one_plain(spec, p, step)
    from . import qz_reconstruct

    return qz_reconstruct.qz_sample_pack_fwd(spec, p, step)


# ---------------------------------------------------------------------------
# Serve half
# ---------------------------------------------------------------------------

def resolve_serve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    """The impl a call runs: the argument, else ``REPRO_SERVE_IMPL``,
    else the kernel for a CUDA tensor and the plain path for a CPU one."""
    impl = impl or os.environ.get("REPRO_SERVE_IMPL")
    if impl is None:
        return "cuda" if x.is_cuda else "chunked"
    if impl not in VALID_SERVE_IMPLS:
        raise ValueError(f"unknown serve impl {impl!r}; valid impls: "
                         f"{', '.join(VALID_SERVE_IMPLS)}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("serve impl 'cuda' needs CUDA tensors; got a "
                         f"tensor on {x.device}")
    return impl


def serve_group_dims(spec: QSpec):
    """(groups, d_in, d_out) of a spec's flat row space: a (L, d_in,
    d_out) leaf has L groups of contiguous rows, a 2-D leaf one."""
    if spec.shard_count != 1 or spec.major_axis != 0:
        raise ValueError(
            "serve ops address the single-block identity row layout "
            f"(shard_count=1, major_axis=0); spec has shard_count="
            f"{spec.shard_count}, major_axis={spec.major_axis}")
    if len(spec.shape) < 2:
        raise ValueError(f"serve ops need a >=2-D spec, got {spec.shape}")
    if len(spec.shape) == 2:
        return 1, spec.shape[0], spec.shape[1]
    d_in = 1
    for s in spec.shape[1:-1]:
        d_in *= s
    return spec.shape[0], d_in, spec.shape[-1]


def serve_block_grid(spec: QSpec, bm: int, row_offset: int, sub: int):
    """(w0, nblocks, bpw): the canonical blocks of a group's rows
    [row_offset, row_offset + sub), in ascending (window, block) order."""
    bpw = max(1, -(-spec.rows_per_window // bm))
    w0 = row_offset // spec.rows_per_window
    w1 = (row_offset + sub - 1) // spec.rows_per_window
    return w0, (w1 - w0 + 1) * bpw, bpw


def serve_block_of(spec: QSpec, rows: torch.Tensor, bm: int) -> torch.Tensor:
    """Canonical block index of each flat row (ascending with the row)."""
    bpw = max(1, -(-spec.rows_per_window // bm))
    win = rows // spec.rows_per_window
    return win * bpw + (rows - win * spec.rows_per_window) // bm


def serve_operand(words: torch.Tensor, qbits: Optional[int]) -> torch.Tensor:
    """The kernel's score operand: f32 scores clipped to probabilities,
    or the codec's uint8/uint16 words as they are."""
    if qbits is None:
        return torch.clamp(words.to(torch.float32), 0.0, 1.0)
    want = {8: torch.uint8, 16: torch.uint16}.get(qbits)
    if want is None:
        raise NotImplementedError(
            f"{qbits}-bit words: the packed sub-byte carry is not ported "
            "yet; the port serves f32, u16 and u8")
    if words.dtype != want:
        raise ValueError(f"{qbits}-bit words must be {want}, got "
                         f"{words.dtype}")
    return words


def serve_edge_bits(spec: QSpec, p: torch.Tensor, step,
                    rows: torch.Tensor, qbits: Optional[int]) -> torch.Tensor:
    """The mask bit (float32 0/1, ``(..., d)``) of each Q edge of the
    flat rows ``rows``, drawn from the score operand ``p``
    (``serve_operand``) at the edge's global z coordinate."""
    rows = rows.to(torch.int64)
    idx = row_indices(spec, rows)
    coords = (rows // spec.rows_per_window)[..., None] * spec.window + idx
    u = mask_u32(spec.seed, spec.tensor_id, as_word(step), coords)
    if qbits is None:
        return bernoulli_u32(u, p[coords])
    thr = quant_threshold_u24(word_values(p)[coords], qbits)
    return ((u >> 8) < thr).to(torch.float32)


def serve_edge_weights(spec: QSpec, p: torch.Tensor, step,
                       rows: torch.Tensor, qbits: Optional[int]):
    """Streamed weight values at flat rows ``rows``: the rows' Q values
    times their edges' mask bits, summed in ascending k."""
    prod = row_values(spec, rows) * serve_edge_bits(spec, p, step, rows,
                                                   qbits)
    acc = prod[..., 0]
    for k in range(1, spec.d):
        acc = acc + prod[..., k]
    return acc


def serve_contract_plain(spec: QSpec, p: torch.Tensor, step,
                         X: torch.Tensor, row_offset: int, d_in: int,
                         d_out: int, qbits: Optional[int],
                         bm: int = SERVE_BM) -> torch.Tensor:
    """The plain torch version of the serve kernels: (B, d_in) -> (B,
    d_out) through the canonical tree, regenerating the weights a few
    input rows at a time."""
    dev = X.device
    X = X.to(torch.float32)
    B = X.shape[0]
    y = torch.zeros((B, d_out), dtype=torch.float32, device=dev)
    part = torch.zeros_like(y)
    cols = torch.arange(d_out, dtype=torch.int64, device=dev)
    step_rows = max(1, _CHUNK_EDGES // (d_out * spec.d))
    for i0 in range(0, d_in, step_rows):
        i1 = min(d_in, i0 + step_rows)
        ii = torch.arange(i0, i1, dtype=torch.int64, device=dev)
        rows = row_offset + ii[:, None] * d_out + cols  # (ci, d_out)
        W = serve_edge_weights(spec, p, step, rows, qbits)
        blk = serve_block_of(spec, rows, bm)
        nxt = serve_block_of(spec, rows + d_out, bm)
        flush = (blk != nxt) | (ii[:, None] == d_in - 1)
        for c in range(i1 - i0):
            part = part + X[:, i0 + c, None] * W[c]
            y = torch.where(flush[c], y + part, y)
            part = torch.where(flush[c], 0.0, part)
    return y


def _contract(spec: QSpec, words, step, X, group: int,
              qbits: Optional[int], impl: Optional[str], bm: int, single):
    groups, d_in, d_out = serve_group_dims(spec)
    if not 0 <= group < groups:
        raise ValueError(f"group {group} out of range [0, {groups})")
    if X.shape[-1] != d_in:
        raise ValueError(f"activation has trailing dim {X.shape[-1]}, spec "
                         f"group expects d_in={d_in}")
    if words.device != X.device:
        raise ValueError(f"words on {words.device}, activations on "
                         f"{X.device}")
    impl = resolve_serve_impl(impl, X)
    row_offset = group * d_in * d_out
    p = serve_operand(words, qbits)
    if impl == "cuda":
        from . import qz_decode

        fn = qz_decode.qz_sample_matvec if single else qz_decode.qz_sample_matmul
        return fn(spec, p, step, X, row_offset=row_offset, d_in=d_in,
                  d_out=d_out, qbits=qbits, bm=bm)
    Xb = X[None] if single else X
    y = serve_contract_plain(spec, p, step, Xb, row_offset, d_in, d_out,
                             qbits, bm)
    return y[0] if single else y


def serve_matvec(spec: QSpec, words: torch.Tensor, step, x: torch.Tensor, *,
                 group: int = 0, qbits: Optional[int] = None,
                 impl: Optional[str] = None, bm: int = SERVE_BM):
    """Streamed y = x @ W_g: encoded words + x (d_in,) -> (d_out,) f32.

    ``words``: f32 scores (clipped in-op), or the codec's uint8/uint16
    words with ``qbits`` set.  ``step`` is the draw word; ``group``
    selects the stacked layer.
    """
    if x.ndim != 1:
        raise ValueError(f"serve_matvec takes x (d_in,), got {tuple(x.shape)}")
    return _contract(spec, words, step, x, int(group), qbits, impl,
                     int(bm), True)


def serve_matmul(spec: QSpec, words: torch.Tensor, step, X: torch.Tensor, *,
                 group: int = 0, qbits: Optional[int] = None,
                 impl: Optional[str] = None, bm: int = SERVE_BM):
    """Streamed Y = X @ W_g for a (B, d_in) batch -> (B, d_out) f32."""
    if X.ndim != 2:
        raise ValueError(f"serve_matmul takes X (B, d_in), got "
                         f"{tuple(X.shape)}")
    return _contract(spec, words, step, X, int(group), qbits, impl,
                     int(bm), False)


def serve_embed_rows(spec: QSpec, words: torch.Tensor, step,
                     tokens: torch.Tensor, *, qbits: Optional[int] = None):
    """Streamed embedding rows: tokens (...) -> (..., d_model) f32.

    Row t of the (vocab, d_model) table is the flat-row run
    [t*d_model, (t+1)*d_model); plain torch on every device, as in the
    JAX package (a gather has no contraction to fuse into).
    """
    groups, _, d_out = serve_group_dims(spec)
    if groups != 1:
        raise ValueError(f"serve_embed_rows addresses 2-D table leaves; "
                         f"spec shape {spec.shape} has {groups} groups")
    p = serve_operand(words, qbits)
    cols = torch.arange(d_out, dtype=torch.int64, device=tokens.device)
    rows = tokens.to(torch.int64)[..., None] * d_out + cols
    return serve_edge_weights(spec, p, step, rows, qbits)
