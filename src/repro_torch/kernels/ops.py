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
THE MODEL AXIS.  ``model_size``/``row_sharding`` (a model
``comm.shardmap.AxisGroup``, the JAX package's ``_resolve_model_size``)
route a spec built with ``shard_count > 1`` to ``kernels.qz_sharded``,
as the JAX package's ``_fwd_one``/``_bwd_one``/``_fwd_many``/
``_bwd_many`` and fused forwards dispatch: the operand is this rank's
slice of the scores (n_loc coordinates), the result its block of the
tensor's major axis, and the backward its slice's gradient.  A spec
with ``shard_count == 1`` takes the global op, replicated on every
model rank.  The serve ops refuse a sharded layout, as the JAX
package's do.
Impl dispatch: ``"cuda"`` (the kernels) or ``"ref"``
(the plain torch versions below), by the argument, else
``REPRO_RECONSTRUCT_IMPL``, else the tensor's device; ``"cuda"`` on a
CPU tensor raises.  The round calls the batched ops directly: there are
no vmap rules to install.

SERVE HALF.  Every zampled linear of the serving engine calls
``serve_matmul`` (or ``serve_matvec`` at B=1); each regenerates the
group's Q edges, draws the mask bits straight from the encoded score
words (f32, u8/u16, or a packed codec's uint32 lanes), and contracts
against the activations.  The load mode's ``serve_resident_*`` read
the weights from a reconstructed leaf instead, and the cached mode's
``serve_cached_*`` from the hot-block tile pool where a block has a
slot (``serve_fill_tiles`` fills it); the three are one kernel with a
weight source, and one plain tree (``serve_contract_plain``).  Impl
dispatch:
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

THE SIGN OF ZERO.  A weight whose products are all +-0 (no edge drawn)
is -0 in the plain path iff every product is -0 (a negative value times
a 0 bit); the fill kernel and kernel 7 keep that rule, so pool tiles
and resident leaves equal their plain versions by bits.  The serve
kernel's own regeneration adds +0 for an undrawn edge instead.  Y does
not see the difference: its sums start at +0, so a ±0 product leaves a
sum as it is, and Y is never -0.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..comm.bitpack import (pack_mask, packed_word_len, unpack_words,
                            words_per_lane)
from ..core.hashrng import bernoulli_u32
from ..core.qspec import QSpec, row_indices, row_values
from ..core.reconstruct import (_insert_padding_batched, _move_batched,
                                _rows_sum, _unmove_batched,
                                plan_apply_batched, range_real_rows,
                                reconstruct_batched_ref,
                                scatter_apply_batched, scatter_windows)
from ..core.sampling import (as_word, as_words, mask_u32,
                              quant_threshold_u24, sample_mask_hash,
                              sample_mask_qhash, word_values)
from ..core.transpose_plan import plan_windows, resolve_bwd_path, row_plan

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


def _coords(spec: QSpec, windows) -> tuple:
    """(first coordinate, coordinates) of the range ``windows``."""
    w0, w1 = plan_windows(spec, windows)
    return w0 * spec.window, (w1 - w0) * spec.window


def _draw(spec: QSpec, P: torch.Tensor, steps: torch.Tensor, qbits,
          qpacked: bool = False, windows=None):
    c0, n = _coords(spec, windows)
    if qbits is None:
        return sample_mask_hash(P, spec.seed, spec.tensor_id, steps, c0)
    if qpacked:  # the per-coordinate words first: JAX ops._sample_one
        P = unpack_words(P, n, qbits)
    return sample_mask_qhash(P, qbits, spec.seed, spec.tensor_id, steps, c0)


def _range_padding(spec: QSpec, G: torch.Tensor, windows) -> torch.Tensor:
    """(K, m_out) cotangents of a range's real rows -> (K, its padded
    rows), padding rows +0."""
    G = G.to(torch.float32)
    if windows is None:
        return _insert_padding_batched(spec, G)
    real = range_real_rows(spec, windows, G.device)
    g_pad = G.new_zeros((G.shape[0], real.numel()))
    g_pad[:, real] = G
    return g_pad


def reconstruct_plain(spec: QSpec, Z: torch.Tensor,
                      windows=None) -> torch.Tensor:
    """The plain torch version of kernels 3 and 1: (K, n) operands ->
    W (K, m) in moved flat order, each row summing its edge value times
    the client's operand in ascending k: ``reconstruct_batched_ref``.
    Over ``windows`` (w0, w1): the range's (K, n_out) operands -> its
    (K, m_out) real rows, the same sums."""
    if windows is None:
        return _move_batched(spec, reconstruct_batched_ref(spec, Z))
    n = _coords(spec, windows)[1]
    if Z.ndim != 2 or Z.shape[-1] != n:
        raise ValueError(f"Z has shape {tuple(Z.shape)}, the range "
                         f"expects (K, {n})")
    gidx, vals = row_plan(spec, Z.device, windows)
    w_pad = _rows_sum(vals, Z.to(torch.float32)[:, gidx])
    return w_pad[:, range_real_rows(spec, windows, Z.device)]


def sample_reconstruct_plain(spec: QSpec, P: torch.Tensor, steps,
                             qbits: Optional[int] = None,
                             qpacked: bool = False,
                             windows=None) -> torch.Tensor:
    """The plain torch version of kernels 8 and 7: (K, n) operand (or,
    with ``qpacked``, (K, packed_word_len(n, qbits)) lanes, unpacked to
    words first) + (K,) draw words -> W (K, m) in moved flat order: the
    drawn masks through ``reconstruct_plain``, as the kernel multiplies
    each edge value by the client's drawn bit.  Over ``windows``: the
    range's operand, drawn at its global coordinates."""
    steps = as_words(steps, P.device).reshape(-1)
    return reconstruct_plain(
        spec, _draw(spec, P, steps, qbits, qpacked, windows), windows)


def plan_bwd_plain(spec: QSpec, G: torch.Tensor, order: str = "canonical",
                   windows=None) -> torch.Tensor:
    """The plain torch version of kernel 6: (K, m) cotangents in moved
    flat order -> (K, n) over the ``order`` transpose plan (over
    ``windows``: the range's (K, m_out) -> (K, n_out))."""
    return plan_apply_batched(spec, _range_padding(spec, G, windows), order,
                              windows)


def plan_bwd_one_plain(spec: QSpec, g: torch.Tensor,
                       order: str = "canonical",
                       windows=None) -> torch.Tensor:
    """The plain torch version of kernel 5: one (m,) cotangent in moved
    flat order -> (n,) over the ``order`` transpose plan."""
    return plan_bwd_plain(spec, g[None], order, windows)[0]


def scatter_bwd_plain(spec: QSpec, G: torch.Tensor,
                      windows=None) -> torch.Tensor:
    """The plain torch version of kernel 4: (K, m) cotangents in moved
    flat order -> (K, n) by the scatter, a chunk of windows at a time,
    no plan held (``core.reconstruct.scatter_apply_batched``; over
    ``windows``: the range's (K, m_out) -> (K, n_out))."""
    return scatter_apply_batched(spec, _range_padding(spec, G, windows),
                                 windows)


def scatter_bwd_windows_plain(spec: QSpec, G: torch.Tensor,
                              windows) -> torch.Tensor:
    """Kernel 4's plain version at some windows alone: (K, m) cotangents
    in moved flat order -> (K, len(windows), window), the listed windows'
    coordinates, gathering only those windows' rows (so it checks a leaf
    too large for ``scatter_bwd_plain`` at sampled windows).  Equals the
    same columns of ``scatter_bwd_plain`` bit for bit."""
    G = G.to(torch.float32)
    rpw, outs = spec.rows_per_window, []
    for w in windows:
        rp = torch.arange(w * rpw, (w + 1) * rpw, dtype=torch.int64,
                          device=G.device)
        blk, loc = rp // spec.m_pad_loc, rp % spec.m_pad_loc
        real = loc < spec.m_blk  # padding rows read +0, as inserted
        g = torch.where(real, G[:, torch.where(real, blk * spec.m_blk + loc,
                                               0)], 0.0)
        outs.append(scatter_windows(spec, g, w, w + 1))
    return torch.stack(outs, 1)


def scatter_bwd_one_plain(spec: QSpec, g: torch.Tensor,
                          windows=None) -> torch.Tensor:
    """The plain torch version of kernel 2: one (m,) cotangent -> (n,)."""
    return scatter_bwd_plain(spec, g[None], windows)[0]


def sample_pack_plain(spec: QSpec, P: torch.Tensor, steps,
                      windows=None) -> torch.Tensor:
    """The plain torch version of kernel 10: (K, n) probabilities ->
    (K, ceil(n/32)) upload lanes (over ``windows``: the range's
    coordinates, drawn at their global index)."""
    steps = as_words(steps, P.device).reshape(-1)
    return pack_mask(sample_mask_hash(P, spec.seed, spec.tensor_id, steps,
                                      _coords(spec, windows)[0]))


def sample_pack_one_plain(spec: QSpec, p: torch.Tensor, step,
                          windows=None) -> torch.Tensor:
    """The plain torch version of kernel 9: (n,) probabilities and one
    draw word -> (ceil(n/32),) upload lanes."""
    return pack_mask(sample_mask_hash(p, spec.seed, spec.tensor_id,
                                      as_word(step),
                                      _coords(spec, windows)[0]))


def _model_shard(spec: QSpec, model_size, row_sharding):
    """(sid, ms) where the op runs on a model rank's shard of ``spec``,
    else None (no model axis, or a leaf the axis replicates)."""
    if row_sharding is None:
        if model_size not in (None, 1):
            raise ValueError(f"model_size={model_size} needs row_sharding, "
                             "this rank's model AxisGroup")
        shard = None if model_size is None else (0, 1)
    else:
        if model_size is not None and model_size != row_sharding.size:
            raise ValueError(f"model_size={model_size} but row_sharding "
                             f"spans {row_sharding.size} ranks")
        shard = (row_sharding.index, row_sharding.size)
    if shard is None or spec.shard_count == 1:
        return None
    return shard


def _fwd_many(spec, P, steps, impl, qbits, single, qpacked=False,
              shard=None):
    """Kernels 7/8 (a draw at ``steps``) or 1/3 (``steps`` None: P is
    the explicit operand); on ``shard`` (sid, ms) the shard's block."""
    if shard is not None:
        from . import qz_sharded as qs

        if steps is None:
            if single:
                return qs.sharded_reconstruct(spec, P[0], *shard,
                                              impl=impl)[None]
            return qs.sharded_reconstruct_batched(spec, P, *shard, impl=impl)
        if single:
            return qs.sharded_sample_reconstruct(
                spec, P[0], steps, *shard, qbits=qbits, qpacked=qpacked,
                impl=impl)[None]
        return qs.sharded_sample_reconstruct_batched(
            spec, P, steps, *shard, qbits=qbits, qpacked=qpacked, impl=impl)
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


def _bwd_many(spec, G, impl, single, shard=None):
    """The transpose the gate names, read when the backward runs: the
    plan of either order on kernel 6 (kernel 5 for one client), or the
    scatter on kernel 4 (kernel 2 for one client); on ``shard`` over the
    shard's windows, from the (K, *block) cotangent of its block."""
    if shard is not None:
        from . import qz_sharded as qs

        if single:
            return qs.sharded_grad_z(spec, G[0], *shard, impl=impl)[None]
        return qs.sharded_grad_z_batched(spec, G, *shard, impl=impl)
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
    either way grad = Q^T grad_W.  Without a shard W is (K, m) in moved
    flat order; on a shard it is the (K, *block) block."""

    @staticmethod
    def forward(ctx, P, steps, spec, impl, single, shard):
        ctx.spec, ctx.impl, ctx.single, ctx.shard = spec, impl, single, shard
        return _fwd_many(spec, P, steps, impl, None, single, shard=shard)

    @staticmethod
    def backward(ctx, gW):
        return (_bwd_many(ctx.spec, gW.contiguous(), ctx.impl, ctx.single,
                          ctx.shard), None, None, None, None, None)


def _check_batched(spec, P, what, n=None):
    n = spec.n if n is None else n
    if P.ndim != 2 or P.shape[-1] != n:
        raise ValueError(f"{what} has shape {tuple(P.shape)}, spec "
                         f"expects (K, {n})")


def _operand_n(spec: QSpec, shard) -> int:
    """Coordinates of the operand: n, or a shard's n_loc."""
    return spec.n if shard is None else spec.nw_loc * spec.window


def _output(spec: QSpec, W: torch.Tensor, shard) -> torch.Tensor:
    """(K, m) moved flat rows -> (K, *shape); a shard's block as it is."""
    return W if shard is not None else _unmove_batched(spec, W)


def _sample_reconstruct(spec, P, steps, qbits, qpacked, impl, single,
                        model_size, row_sharding):
    if qpacked and qbits is None:
        raise ValueError("qpacked requires qbits (a packed codec width)")
    shard = _model_shard(spec, model_size, row_sharding)
    n = _operand_n(spec, shard)
    _check_batched(spec, P, "operand",
                   packed_word_len(n, int(qbits)) if qpacked else n)
    impl = resolve_impl(impl, P)
    steps = as_words(steps, P.device).reshape(-1)
    if qbits is not None:
        W = _fwd_many(spec, P.contiguous(), steps, impl, int(qbits), single,
                      bool(qpacked), shard)
    else:
        W = _Reconstruct.apply(P.to(torch.float32).contiguous(), steps,
                               spec, impl, single, shard)
    return _output(spec, W, shard)


def _reconstruct(spec, Z, impl, single, model_size, row_sharding):
    shard = _model_shard(spec, model_size, row_sharding)
    _check_batched(spec, Z, "Z", _operand_n(spec, shard))
    impl = resolve_impl(impl, Z)
    W = _Reconstruct.apply(Z.to(torch.float32).contiguous(), None, spec,
                           impl, single, shard)
    return _output(spec, W, shard)


def reconstruct_batched(spec: QSpec, Z: torch.Tensor, *,
                        impl: Optional[str] = None, model_size=None,
                        row_sharding=None) -> torch.Tensor:
    """W_k = Q z^(k) for K stacked clients: Z (K, n) -> (K, *spec.shape)
    f32, differentiable in Z (grad = Q^T grad_W).  Kernel 3 forward,
    kernel 6 backward.  On a model axis (``row_sharding``, see the
    module's docstring) a sharded spec takes this rank's (K, n_loc)
    slice and gives its (K, *block)."""
    return _reconstruct(spec, Z, impl, False, model_size, row_sharding)


def reconstruct(spec: QSpec, z: torch.Tensor, *,
                impl: Optional[str] = None, model_size=None,
                row_sharding=None) -> torch.Tensor:
    """w = Q z for one operand: (n,) -> spec.shape f32, differentiable
    in z.  Kernel 1 forward, kernel 5 backward (on a model axis, a
    rank's slice and block, as ``reconstruct_batched``)."""
    if z.ndim != 1:
        raise ValueError(f"z has shape {tuple(z.shape)}, spec expects "
                         f"({spec.n},)")
    return _reconstruct(spec, z[None], impl, True, model_size,
                        row_sharding)[0]


def sample_reconstruct_batched(spec: QSpec, P: torch.Tensor, steps, *,
                               qbits: Optional[int] = None,
                               qpacked: bool = False,
                               impl: Optional[str] = None, model_size=None,
                               row_sharding=None) -> torch.Tensor:
    """Fused W_k = Q Bern(P_k) for K stacked clients: P (K, n) clipped
    probabilities + (K,) draw words -> (K, *spec.shape) f32.

    Differentiable in P (straight-through); chain through
    ``clip_probs`` for the paper's gate.  With ``qbits`` P is the
    (K, n) u8/u16 word slab and the draw is the threshold compare; with
    ``qpacked`` too it is the (K, packed_word_len(n, qbits)) uint32 lane
    slab of a packed codec.  On a model axis a sharded spec takes this
    rank's slice (n_loc coordinates, or their lanes) and gives its
    block, drawn at global coordinates."""
    return _sample_reconstruct(spec, P, steps, qbits, qpacked, impl, False,
                               model_size, row_sharding)


def sample_reconstruct(spec: QSpec, p: torch.Tensor, step, *,
                       qbits: Optional[int] = None, qpacked: bool = False,
                       impl: Optional[str] = None, model_size=None,
                       row_sharding=None) -> torch.Tensor:
    """Fused w = Q Bern(p) for one client: (n,) + a draw word ->
    spec.shape f32 (``qbits``/``qpacked``/``row_sharding`` as for the
    batched op).  Kernel 7 (the batched kernel at K=1) forward, kernel
    5 backward."""
    return _sample_reconstruct(spec, p[None], step, qbits, qpacked, impl,
                               True, model_size, row_sharding)[0]


def sample_pack_batched(spec: QSpec, P: torch.Tensor, steps, *,
                        impl: Optional[str] = None,
                        row_sharding=None) -> torch.Tensor:
    """Fused upload draw for K clients: P (K, n) probabilities + (K,)
    draw words -> (K, ceil(n/32)) lanes (int64 holding uint32), equal
    to ``pack_mask(sample_mask_hash(P, ...))``.  No gradient.  On a
    model axis a sharded spec packs this rank's (K, n_loc) slice into
    its lanes of the upload."""
    shard = _model_shard(spec, None, row_sharding)
    if P.ndim != 2 or P.shape[-1] != _operand_n(spec, shard):
        raise ValueError(f"P has shape {tuple(P.shape)}, spec expects "
                         f"(K, {_operand_n(spec, shard)})")
    impl = resolve_impl(impl, P)
    if shard is not None:
        from .qz_sharded import sharded_sample_pack_batched

        return sharded_sample_pack_batched(spec, P, steps, *shard, impl=impl)
    steps = as_words(steps, P.device).reshape(-1)
    P = P.detach().to(torch.float32).contiguous()
    # the kernel emits whole lanes per window, as the Pallas one does
    if impl == "ref" or spec.window % 32 != 0:
        return sample_pack_plain(spec, P, steps)
    from . import qz_reconstruct

    return qz_reconstruct.qz_sample_pack_batched_fwd(spec, P, steps)


def sample_pack(spec: QSpec, p: torch.Tensor, step: int, *,
                impl: Optional[str] = None,
                row_sharding=None) -> torch.Tensor:
    """Fused upload draw for one client: p (n,) + one draw word ->
    (ceil(n/32),) lanes, equal to ``sample_pack_batched``'s row.  Kernel
    9; no gradient (on a model axis, this rank's slice and lanes)."""
    shard = _model_shard(spec, None, row_sharding)
    if p.ndim != 1 or p.shape[0] != _operand_n(spec, shard):
        raise ValueError(f"p has shape {tuple(p.shape)}, spec expects "
                         f"({_operand_n(spec, shard)},)")
    impl = resolve_impl(impl, p)
    if shard is not None:
        from .qz_sharded import sharded_sample_pack

        return sharded_sample_pack(spec, p, step, *shard, impl=impl)
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


def serve_operand(words: torch.Tensor, qbits: Optional[int],
                  qpacked: bool = False) -> torch.Tensor:
    """The kernel's score operand: f32 scores clipped to probabilities,
    the codec's uint8/uint16 words, or (``qpacked``) a packed codec's
    uint32 lanes, as they are."""
    if qbits is None:
        if qpacked:
            raise ValueError("qpacked requires qbits (a packed codec width)")
        return torch.clamp(words.to(torch.float32), 0.0, 1.0)
    if qpacked:
        words_per_lane(int(qbits))  # b in [1, 16]
        want = torch.uint32
    else:
        want = {8: torch.uint8, 16: torch.uint16}.get(qbits)
        if want is None:
            raise ValueError(f"{qbits}-bit words are carried packed: pass "
                             "qpacked=True with the uint32 lanes")
    if words.dtype != want:
        raise ValueError(f"{qbits}-bit {'lanes' if qpacked else 'words'} "
                         f"must be {want}, got {words.dtype}")
    return words


def _edge_words(p: torch.Tensor, coords: torch.Tensor, qbits: int,
                qpacked: bool) -> torch.Tensor:
    """The b-bit word (int64) at each coordinate: a word array indexed,
    or each coordinate's lane ``coords // wpl`` gathered (through an
    int32 view) and its word shifted out; no per-coordinate slab."""
    if not qpacked:
        return word_values(p)[coords]
    wpl = words_per_lane(qbits)
    lanes = p.view(torch.int32)[coords // wpl].to(torch.int64) & 0xFFFFFFFF
    return (lanes >> (qbits * (coords % wpl))) & ((1 << qbits) - 1)


def drawn_bits_at(spec: QSpec, p: torch.Tensor, step, coords: torch.Tensor,
                  qbits: Optional[int], qpacked: bool = False) -> torch.Tensor:
    """The serve kernels' draw: the mask bit (bool) at each global z
    coordinate in ``coords`` (int64, any shape), from the score operand
    ``p`` (``serve_operand``).  The one statement of the rule that the
    edge bits, the tile fill and a delta's flip map share."""
    u = mask_u32(spec.seed, spec.tensor_id, as_word(step), coords)
    if qbits is None:
        return bernoulli_u32(u, p[coords]) > 0
    return (u >> 8) < quant_threshold_u24(
        _edge_words(p, coords, qbits, qpacked), qbits)


def serve_edge_bits(spec: QSpec, p: torch.Tensor, step, rows: torch.Tensor,
                    qbits: Optional[int],
                    qpacked: bool = False) -> torch.Tensor:
    """The mask bit (float32 0/1, ``(..., d)``) of each Q edge of the
    flat rows ``rows``, drawn from the score operand ``p``
    (``serve_operand``) at the edge's global z coordinate."""
    rows = rows.to(torch.int64)
    idx = row_indices(spec, rows)
    win = rows // spec.rows_per_window
    coords = win[..., None] * spec.window + idx
    if not rows.is_cuda and rows.numel():
        # each coordinate is read by many edges: on the host, draw the
        # rows' windows once and gather (the same bits, far fewer hashes)
        lo = int(win.min()) * spec.window
        hi = (int(win.max()) + 1) * spec.window
        if hi - lo < coords.numel():
            span = torch.arange(lo, hi, dtype=torch.int64)
            bits = drawn_bits_at(spec, p, step, span, qbits, qpacked)
            return bits[coords - lo].to(torch.float32)
    return drawn_bits_at(spec, p, step, coords, qbits,
                         qpacked).to(torch.float32)


def serve_edge_weights(spec: QSpec, p: torch.Tensor, step,
                       rows: torch.Tensor, qbits: Optional[int],
                       qpacked: bool = False):
    """Streamed weight values at flat rows ``rows``: the rows' Q values
    times their edges' mask bits, summed in ascending k."""
    prod = row_values(spec, rows) * serve_edge_bits(spec, p, step, rows,
                                                   qbits, qpacked)
    acc = prod[..., 0]
    for k in range(1, spec.d):
        acc = acc + prod[..., k]
    return acc


def _block_coords(spec: QSpec, rows: torch.Tensor, w0: int, bm: int):
    """(t, lane) of flat rows: the canonical block index relative to the
    group's first window ``w0`` (the slot map's column) and the row's
    place in its block (the pool row's column)."""
    rpw = spec.rows_per_window
    bpw = max(1, -(-rpw // bm))
    win = rows // rpw
    within = rows - win * rpw
    return (win - w0) * bpw + within // bm, within % bm


def _plain_weights(spec: QSpec, rows: torch.Tensor, p, step, qbits, qpacked,
                   W, pool, slots, w0: int, bm: int) -> torch.Tensor:
    """Weights at flat rows from one of the three sources: regenerated
    from the words, read from a resident leaf ``W``, or read from the
    tile pool where the row's block has a slot and regenerated where it
    has none."""
    if W is not None:
        return W.reshape(-1)[rows]
    if pool is None:
        return serve_edge_weights(spec, p, step, rows, qbits, qpacked)
    t, lane = _block_coords(spec, rows, w0, bm)
    slot = slots.to(torch.int64)[t]
    hit = slot >= 0
    out = torch.empty(rows.shape, dtype=torch.float32, device=rows.device)
    out[hit] = pool[slot[hit], lane[hit]]
    if not bool(hit.all()):
        out[~hit] = serve_edge_weights(spec, p, step, rows[~hit], qbits,
                                       qpacked)
    return out


def serve_contract_plain(spec: QSpec, p: Optional[torch.Tensor], step,
                         X: torch.Tensor, row_offset: int, d_in: int,
                         d_out: int, qbits: Optional[int],
                         bm: int = SERVE_BM, *, qpacked: bool = False,
                         W: Optional[torch.Tensor] = None,
                         pool: Optional[torch.Tensor] = None,
                         slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain torch version of the serve kernels: (B, d_in) -> (B,
    d_out) through the canonical tree, the weights taken a few input
    rows at a time from one source: regenerated from the operand ``p``
    (streaming), read from the resident leaf ``W`` (load), or from the
    tile ``pool`` by the group's ``slots`` map with the rest regenerated
    (cached).  One tree for the three, so they give the same bits."""
    dev = X.device
    X = X.to(torch.float32)
    B = X.shape[0]
    y = torch.zeros((B, d_out), dtype=torch.float32, device=dev)
    part = torch.zeros_like(y)
    cols = torch.arange(d_out, dtype=torch.int64, device=dev)
    w0 = row_offset // spec.rows_per_window
    step_rows = max(1, _CHUNK_EDGES // (d_out * spec.d))
    for i0 in range(0, d_in, step_rows):
        i1 = min(d_in, i0 + step_rows)
        ii = torch.arange(i0, i1, dtype=torch.int64, device=dev)
        rows = row_offset + ii[:, None] * d_out + cols  # (ci, d_out)
        Wc = _plain_weights(spec, rows, p, step, qbits, qpacked, W, pool,
                            slots, w0, bm)
        blk = serve_block_of(spec, rows, bm)
        nxt = serve_block_of(spec, rows + d_out, bm)
        flush = (blk != nxt) | (ii[:, None] == d_in - 1)
        for c in range(i1 - i0):
            part = part + X[:, i0 + c, None] * Wc[c]
            y = torch.where(flush[c], y + part, y)
            part = torch.where(flush[c], 0.0, part)
    return y


def _group_rows(spec: QSpec, group: int, X: torch.Tensor):
    """(row_offset, d_in, d_out) of ``group``, checked against X."""
    groups, d_in, d_out = serve_group_dims(spec)
    if not 0 <= group < groups:
        raise ValueError(f"group {group} out of range [0, {groups})")
    if X.shape[-1] != d_in:
        raise ValueError(f"activation has trailing dim {X.shape[-1]}, spec "
                         f"group expects d_in={d_in}")
    return group * d_in * d_out, d_in, d_out


def _same_device(a: torch.Tensor, X: torch.Tensor, what: str) -> None:
    if a.device != X.device:
        raise ValueError(f"{what} on {a.device}, activations on {X.device}")


def _contract(spec: QSpec, words, step, X, group: int,
              qbits: Optional[int], qpacked: bool, impl: Optional[str],
              bm: int, single: bool):
    row_offset, d_in, d_out = _group_rows(spec, group, X)
    _same_device(words, X, "words")
    impl = resolve_serve_impl(impl, X)
    p = serve_operand(words, qbits, qpacked)
    if impl == "cuda":
        from . import qz_decode

        fn = qz_decode.qz_sample_matvec if single else qz_decode.qz_sample_matmul
        return fn(spec, p, step, X, row_offset=row_offset, d_in=d_in,
                  d_out=d_out, qbits=qbits, qpacked=qpacked, bm=bm)
    Xb = X[None] if single else X
    y = serve_contract_plain(spec, p, step, Xb, row_offset, d_in, d_out,
                             qbits, bm, qpacked=qpacked)
    return y[0] if single else y


def _check_rank(X, ndim: int, name: str):
    if X.ndim != ndim:
        want = "x (d_in,)" if ndim == 1 else "X (B, d_in)"
        raise ValueError(f"{name} takes {want}, got {tuple(X.shape)}")


def serve_matvec(spec: QSpec, words: torch.Tensor, step, x: torch.Tensor, *,
                 group: int = 0, qbits: Optional[int] = None,
                 qpacked: bool = False, impl: Optional[str] = None,
                 bm: int = SERVE_BM):
    """Streamed y = x @ W_g: encoded words + x (d_in,) -> (d_out,) f32.

    ``words``: f32 scores (clipped in-op), the codec's uint8/uint16
    words with ``qbits`` set, or a packed codec's uint32 lanes with
    ``qpacked`` too (each edge reads lane ``coord // wpl``).  ``step``
    is the draw word; ``group`` selects the stacked layer.
    """
    _check_rank(x, 1, "serve_matvec")
    return _contract(spec, words, step, x, int(group), qbits, bool(qpacked),
                     impl, int(bm), True)


def serve_matmul(spec: QSpec, words: torch.Tensor, step, X: torch.Tensor, *,
                 group: int = 0, qbits: Optional[int] = None,
                 qpacked: bool = False, impl: Optional[str] = None,
                 bm: int = SERVE_BM):
    """Streamed Y = X @ W_g for a (B, d_in) batch -> (B, d_out) f32."""
    _check_rank(X, 2, "serve_matmul")
    return _contract(spec, words, step, X, int(group), qbits, bool(qpacked),
                     impl, int(bm), False)


def _resident(spec: QSpec, W: torch.Tensor, X, group: int, bm: int):
    row_offset, d_in, d_out = _group_rows(spec, group, X)
    _same_device(W, X, "W")
    if W.numel() != spec.m or W.dtype != torch.float32:
        raise ValueError(f"resident leaf must hold the spec's {spec.m} "
                         f"float32 weights, got {tuple(W.shape)} {W.dtype}")
    if X.is_cuda:
        from . import qz_decode

        return qz_decode.qz_resident_matmul(
            spec, W, X, row_offset=row_offset, d_in=d_in, d_out=d_out, bm=bm)
    return serve_contract_plain(spec, None, 0, X, row_offset, d_in, d_out,
                                None, bm, W=W)


def serve_resident_matvec(spec: QSpec, W: torch.Tensor, x: torch.Tensor, *,
                          group: int = 0, bm: int = SERVE_BM):
    """y = x @ W_g against a materialized leaf (load mode), through the
    canonical tree, so it equals ``serve_matvec`` bit for bit: the
    modes differ in where a weight comes from, not in how it is summed.
    ``W``: the reconstructed leaf (``serve.state.reconstruct_resident``).
    The matmul on ``x[None]``; a CUDA tensor runs the serve kernel's
    resident source."""
    _check_rank(x, 1, "serve_resident_matvec")
    return _resident(spec, W, x[None], int(group), int(bm))[0]


def serve_resident_matmul(spec: QSpec, W: torch.Tensor, X: torch.Tensor, *,
                          group: int = 0, bm: int = SERVE_BM):
    """Y = X @ W_g against a materialized leaf for a (B, d_in) batch."""
    _check_rank(X, 2, "serve_resident_matmul")
    return _resident(spec, W, X, int(group), int(bm))


def serve_cached_matmul(spec: QSpec, words: torch.Tensor, step,
                        X: torch.Tensor, pool: torch.Tensor,
                        slots: torch.Tensor, *, group: int = 0,
                        qbits: Optional[int] = None, qpacked: bool = False,
                        bm: int = SERVE_BM):
    """Streamed Y = X @ W_g with the hot-block cache in the loop.

    ``pool`` (S, bm) f32 and ``slots`` (nblk,) int32 come from
    ``serve.cache.HotBlockCache`` (its slot map of the leaf at
    ``group``).  A block with a slot reads its weights from the pool,
    the others regenerate them; both give the same values, and the
    canonical tree sums them, so the result equals ``serve_matmul`` bit
    for bit at every occupancy.  A CUDA tensor runs the serve kernel's
    cached source."""
    _check_rank(X, 2, "serve_cached_matmul")
    group, bm = int(group), int(bm)
    row_offset, d_in, d_out = _group_rows(spec, group, X)
    for a, what in ((words, "words"), (pool, "pool"), (slots, "slots")):
        _same_device(a, X, what)
    _, nblk, _ = serve_block_grid(spec, bm, row_offset, d_in * d_out)
    if tuple(slots.shape) != (nblk,):
        raise ValueError(f"slots must be the group's ({nblk},) slot map, "
                         f"got {tuple(slots.shape)}")
    if pool.ndim != 2 or pool.shape[1] != bm or pool.dtype != torch.float32:
        raise ValueError(f"pool must be (S, {bm}) float32, got "
                         f"{tuple(pool.shape)} {pool.dtype}")
    p = serve_operand(words, qbits, qpacked)
    if X.is_cuda:
        from . import qz_decode

        return qz_decode.qz_cached_matmul(
            spec, p, step, X, pool, slots, row_offset=row_offset, d_in=d_in,
            d_out=d_out, qbits=qbits, qpacked=bool(qpacked), bm=bm)
    return serve_contract_plain(spec, p, step, X, row_offset, d_in, d_out,
                                qbits, bm, qpacked=bool(qpacked), pool=pool,
                                slots=slots)


def fill_tiles_plain(spec: QSpec, p: torch.Tensor, step,
                     groups_idx: torch.Tensor, blocks: torch.Tensor,
                     qbits: Optional[int], qpacked: bool = False,
                     bm: int = SERVE_BM) -> torch.Tensor:
    """The plain torch version of the tile fill: (T,) (group, canonical
    block) pairs -> (T, bm) weights, exact +0.0 at dead lanes."""
    _, d_in, d_out = serve_group_dims(spec)
    sub = d_in * d_out
    rpw = spec.rows_per_window
    bpw = max(1, -(-rpw // bm))
    g = groups_idx.to(device=p.device, dtype=torch.int64)
    t = blocks.to(device=p.device, dtype=torch.int64)
    row_offset = (g * sub)[:, None]
    j = (t % bpw)[:, None]
    lane = torch.arange(bm, dtype=torch.int64, device=g.device)
    rows = ((row_offset // rpw) + (t // bpw)[:, None]) * rpw + j * bm + lane
    live = ((rows >= row_offset) & (rows < row_offset + sub)
            & (j * bm + lane < rpw) & (rows < spec.m))
    rows = torch.where(live, rows, row_offset)  # a dead lane reads nothing
    out = torch.empty(rows.shape, dtype=torch.float32, device=g.device)
    per = max(1, _CHUNK_EDGES // (bm * spec.d))
    for i0 in range(0, rows.shape[0], per):
        w = serve_edge_weights(spec, p, step, rows[i0:i0 + per], qbits,
                               qpacked)
        out[i0:i0 + per] = torch.where(live[i0:i0 + per], w, 0.0)
    return out


def serve_fill_tiles(spec: QSpec, words: torch.Tensor, step,
                     groups_idx: torch.Tensor, blocks: torch.Tensor, *,
                     qbits: Optional[int] = None, qpacked: bool = False,
                     bm: int = SERVE_BM) -> torch.Tensor:
    """Batched tile fill: the weights of T canonical blocks, (T,) group
    and (T,) block indices -> (T, bm) f32, exact +0.0 at dead lanes:
    the values ``serve_matmul`` regenerates for those blocks, which the
    hot-block cache writes into its pool.  A CUDA tensor runs the fill
    kernel (one thread a (tile, lane))."""
    g = torch.as_tensor(groups_idx)
    t = torch.as_tensor(blocks)
    if g.shape != t.shape or g.ndim != 1:
        raise ValueError(f"groups_idx/blocks must be matching (T,) arrays, "
                         f"got {tuple(g.shape)} vs {tuple(t.shape)}")
    g = g.to(device=words.device, dtype=torch.int32)
    t = t.to(device=words.device, dtype=torch.int32)
    p = serve_operand(words, qbits, qpacked)
    if p.is_cuda:
        from . import qz_decode

        return qz_decode.qz_fill_tiles(spec, p, step, g, t, qbits=qbits,
                                       qpacked=bool(qpacked), bm=int(bm))
    return fill_tiles_plain(spec, p, step, g, t, qbits, bool(qpacked),
                            int(bm))


def serve_embed_rows(spec: QSpec, words: torch.Tensor, step,
                     tokens: torch.Tensor, *, qbits: Optional[int] = None,
                     qpacked: bool = False):
    """Streamed embedding rows: tokens (...) -> (..., d_model) f32.

    Row t of the (vocab, d_model) table is the flat-row run
    [t*d_model, (t+1)*d_model); plain torch on every device, as in the
    JAX package (a gather has no contraction to fuse into).
    """
    groups, _, d_out = serve_group_dims(spec)
    if groups != 1:
        raise ValueError(f"serve_embed_rows addresses 2-D table leaves; "
                         f"spec shape {spec.shape} has {groups} groups")
    p = serve_operand(words, qbits, qpacked)
    cols = torch.arange(d_out, dtype=torch.int64, device=tokens.device)
    rows = tokens.to(torch.int64)[..., None] * d_out + cols
    return serve_edge_weights(spec, p, step, rows, qbits, qpacked)
