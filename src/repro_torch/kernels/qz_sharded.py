"""The model axis: each model rank reconstructs its own block of a leaf.

The JAX package's ``kernels/qz_sharded.py``.  A spec built with
``shard_count = ms`` (QSpec's sharding-major layout: the tensor's
``major_axis`` moved to the front, its rows cut into ``ms`` contiguous
blocks of ``m_pad_loc`` padded rows) gives rank ``sid`` of a model axis
of ``ms`` ranks

 - rows ``[sid * m_pad_loc, (sid + 1) * m_pad_loc)``, which read only
   its windows ``[sid * nw_loc, (sid + 1) * nw_loc)``;
 - so only its slice of the scores, coordinates
   ``[sid * n_loc, (sid + 1) * n_loc)`` (``n_loc = nw_loc * window``);
 - and those rows are block ``sid`` of the tensor's major axis.

So a rank draws, reconstructs and transposes only its own windows, with
zero collectives: the forward kernels (8, 7, 3, 1), the backward ones
(6, 5 on the plan of its windows alone; 4, 2 by the scatter) and the
upload pack (10, 9) run on the window range ``shard_windows``
(``kernels.qz_reconstruct``'s ``windows``).  Every draw hashes global
coordinates, so a rank's bits are the global draw's slice, and its
block equals the same block of the global op by bits: the rows are the
same rows, summed in the same order, and window w's coordinates take
edges from window w's rows only.  The model gets the whole tensor from
``comm.shardmap.gather_major``.

Each function here is a plain function of ``(spec, local operand, sid,
ms)``, so one process can walk every shard; ``kernels.ops`` reads
``(sid, ms)`` from a rank's model ``AxisGroup`` (``row_sharding``).  On
the card a function launches its kernel on the shard's windows; on the
CPU (or with ``impl="ref"``) it runs the kernel's plain version over
the same windows, which walks the canonical order and equals the plain
global op (``core.reconstruct``) block by block.  The backward takes the path the
gate ``REPRO_BWD_PLAN`` names (``core.transpose_plan.resolve_bwd_path``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.qspec import QSpec
from ..core.sampling import as_word, as_words
from ..core.transpose_plan import resolve_bwd_path
from . import qz_reconstruct as qr


def _check(spec: QSpec, ms: int) -> None:
    if spec.shard_count != ms:
        raise ValueError(
            f"spec.shard_count={spec.shard_count} != model axis size {ms}; "
            "build specs with shard_count=model_size")


def shard_windows(spec: QSpec, sid: int, ms: int) -> tuple:
    """Shard ``sid``'s windows (w0, w1) of a spec sharded ``ms`` ways."""
    _check(spec, ms)
    if not 0 <= sid < ms:
        raise ValueError(f"shard {sid} outside a model axis of {ms}")
    return sid * spec.nw_loc, (sid + 1) * spec.nw_loc


def shard_coords(spec: QSpec, sid: int, ms: int) -> tuple:
    """(first coordinate, coordinates) of shard ``sid``'s score slice."""
    w0, w1 = shard_windows(spec, sid, ms)
    return w0 * spec.window, (w1 - w0) * spec.window


def unmove_block(spec: QSpec, ms: int, W: torch.Tensor) -> torch.Tensor:
    """(K, m_blk) rows of a block in moved flat order -> (K, *block)."""
    a = spec.major_axis
    moved = (spec.shape[a] // ms, *spec.shape[:a], *spec.shape[a + 1:])
    return W.reshape(W.shape[0], *moved).movedim(1, a + 1)


def move_block(spec: QSpec, G: torch.Tensor) -> torch.Tensor:
    """(K, *block) -> (K, m_blk) in moved flat order."""
    return G.movedim(spec.major_axis + 1, 1).reshape(G.shape[0], -1)


def _plain(impl: Optional[str], x: torch.Tensor) -> bool:
    return impl == "ref" or not x.is_cuda


def sharded_reconstruct_batched(spec: QSpec, Z: torch.Tensor, sid: int,
                                ms: int, impl: Optional[str] = None):
    """W = Q z^(k) on shard ``sid``: Z (K, n_loc) f32 operands, the
    shard's slice -> (K, *block) f32 (kernel 3 on its windows)."""
    win = shard_windows(spec, sid, ms)
    Z = Z.to(torch.float32).contiguous()
    if _plain(impl, Z):
        from .ops import reconstruct_plain

        W = reconstruct_plain(spec, Z, win)
    else:
        W = qr.qz_reconstruct_batched_fwd(spec, Z, win)
    return unmove_block(spec, ms, W)


def sharded_reconstruct(spec: QSpec, z: torch.Tensor, sid: int, ms: int,
                        impl: Optional[str] = None):
    """w = Q z on shard ``sid``: z (n_loc,) -> the block (kernel 1)."""
    win = shard_windows(spec, sid, ms)
    z = z.to(torch.float32).contiguous()
    if _plain(impl, z):
        from .ops import reconstruct_plain

        w = reconstruct_plain(spec, z[None], win)
    else:
        w = qr.qz_reconstruct_fwd(spec, z, win)[None]
    return unmove_block(spec, ms, w)[0]


def local_draw(spec: QSpec, pl: torch.Tensor, steps, sid: int, ms: int,
               qbits: Optional[int] = None, qpacked: bool = False):
    """Shard ``sid``'s mask bits (f32 {0, 1}, (..., n_loc)), drawn from
    the hash stream at global coordinates: the global draw's slice.
    ``pl``: the shard's f32 probabilities, u8/u16 words with ``qbits``,
    or with ``qpacked`` its (..., n_loc / wpl) slice of a packed lane
    carry; ``steps`` a word, or (K,) words for a (K, ...) operand."""
    from .ops import _draw

    _check_packed(spec, qbits, qpacked)
    if pl.ndim == 2:
        steps = as_words(steps, pl.device).reshape(-1)
        return _draw(spec, pl, steps, qbits, qpacked,
                     shard_windows(spec, sid, ms))
    return _draw(spec, pl[None], as_words([as_word(steps)], pl.device),
                 qbits, qpacked, shard_windows(spec, sid, ms))[0]


def _check_packed(spec: QSpec, qbits, qpacked: bool) -> None:
    if qpacked and spec.window % (32 // qbits) != 0:
        raise ValueError(
            f"packed sharded draw needs window % (32//qbits) == 0; got "
            f"window={spec.window}, qbits={qbits}")


def sharded_sample_reconstruct_batched(spec: QSpec, P: torch.Tensor, steps,
                                       sid: int, ms: int,
                                       qbits: Optional[int] = None,
                                       qpacked: bool = False,
                                       impl: Optional[str] = None):
    """Fused W = Q Bern(p^(k)) on shard ``sid``: P (K, n_loc) clipped f32
    probabilities (u8/u16 words with ``qbits``, or (K, n_loc / wpl)
    packed lanes with ``qpacked``) + (K,) draw words -> (K, *block) f32,
    the draw in the kernel (kernel 8 on its windows)."""
    win = shard_windows(spec, sid, ms)
    _check_packed(spec, qbits, qpacked)
    steps = as_words(steps, P.device).reshape(-1)
    if _plain(impl, P):
        from .ops import sample_reconstruct_plain

        W = sample_reconstruct_plain(spec, P, steps, qbits, qpacked, win)
    else:
        W = qr.qz_sample_reconstruct_batched_fwd(spec, P.contiguous(), steps,
                                                 qbits, qpacked, win)
    return unmove_block(spec, ms, W)


def sharded_sample_reconstruct(spec: QSpec, p: torch.Tensor, step, sid: int,
                               ms: int, qbits: Optional[int] = None,
                               qpacked: bool = False,
                               impl: Optional[str] = None):
    """Fused w = Q Bern(p) on shard ``sid`` for one client: p (n_loc,)
    (or its words or lanes) + a draw word -> the block (kernel 7)."""
    win = shard_windows(spec, sid, ms)
    _check_packed(spec, qbits, qpacked)
    steps = as_words([as_word(step)], p.device)
    if _plain(impl, p):
        from .ops import sample_reconstruct_plain

        w = sample_reconstruct_plain(spec, p[None], steps, qbits, qpacked,
                                     win)
    else:
        w = qr.qz_sample_reconstruct_fwd(spec, p.contiguous(), steps, qbits,
                                         qpacked, win)[None]
    return unmove_block(spec, ms, w)[0]


def sharded_grad_z_batched(spec: QSpec, G: torch.Tensor, sid: int, ms: int,
                           impl: Optional[str] = None):
    """Q^T g per client on shard ``sid``: G (K, *block) cotangents ->
    (K, n_loc) f32, by the plan of its windows (kernel 6) or the scatter
    (kernel 4), as the gate says."""
    win = shard_windows(spec, sid, ms)
    Gm = move_block(spec, G.to(torch.float32)).contiguous()
    kind, order = resolve_bwd_path()
    if _plain(impl, Gm):
        from .ops import plan_bwd_plain, scatter_bwd_plain

        if kind == "plan":
            return plan_bwd_plain(spec, Gm, order, win)
        return scatter_bwd_plain(spec, Gm, win)
    if kind == "plan":
        return qr.qz_reconstruct_batched_bwd_plan(spec, Gm, order, win)
    return qr.qz_reconstruct_batched_bwd(spec, Gm, win)


def sharded_grad_z(spec: QSpec, g: torch.Tensor, sid: int, ms: int,
                   impl: Optional[str] = None):
    """Q^T g on shard ``sid`` for one client: the block's cotangent ->
    (n_loc,) f32, by the plan (kernel 5) or the scatter (kernel 2)."""
    win = shard_windows(spec, sid, ms)
    gm = move_block(spec, g[None].to(torch.float32))[0].contiguous()
    kind, order = resolve_bwd_path()
    if _plain(impl, gm):
        from .ops import plan_bwd_one_plain, scatter_bwd_one_plain

        if kind == "plan":
            return plan_bwd_one_plain(spec, gm, order, win)
        return scatter_bwd_one_plain(spec, gm, win)
    if kind == "plan":
        return qr.qz_reconstruct_bwd_plan(spec, gm, order, win)
    return qr.qz_reconstruct_bwd(spec, gm, win)


def _check_lanes(spec: QSpec, sid: int, ms: int) -> None:
    c0, n = shard_coords(spec, sid, ms)
    if c0 % 32 or n % 32:
        raise ValueError(f"shard {sid} of {ms} holds coordinates [{c0}, "
                         f"{c0 + n}), not whole upload lanes of 32")


def sharded_sample_pack_batched(spec: QSpec, P: torch.Tensor, steps,
                                sid: int, ms: int,
                                impl: Optional[str] = None):
    """Shard ``sid``'s upload lanes for K clients: P (K, n_loc) f32
    probabilities + (K,) draw words -> (K, n_loc / 32) lanes, the global
    upload's lanes of the slice (kernel 10 on its windows)."""
    win = shard_windows(spec, sid, ms)
    _check_lanes(spec, sid, ms)
    steps = as_words(steps, P.device).reshape(-1)
    P = P.detach().to(torch.float32).contiguous()
    if _plain(impl, P):
        from .ops import sample_pack_plain

        return sample_pack_plain(spec, P, steps, win)
    return qr.qz_sample_pack_batched_fwd(spec, P, steps, win)


def sharded_sample_pack(spec: QSpec, p: torch.Tensor, step, sid: int,
                        ms: int, impl: Optional[str] = None):
    """Shard ``sid``'s upload lanes for one client: p (n_loc,) + one draw
    word -> (n_loc / 32,) lanes (kernel 9 on its windows)."""
    win = shard_windows(spec, sid, ms)
    _check_lanes(spec, sid, ms)
    p = p.detach().to(torch.float32).contiguous()
    if _plain(impl, p):
        from .ops import sample_pack_one_plain

        return sample_pack_one_plain(spec, p, step, win)
    return qr.qz_sample_pack_fwd(spec, p, step, win)
