"""Streamed serve matmul/matvec as a CUDA kernel for Hopper (sm_90a).

Replaces the Pallas kernels ``qz_sample_matmul`` and ``qz_sample_matvec``
of the JAX package's ``kernels/qz_decode.py``.  The source is
``csrc/qz_decode.cu`` with its device functions in ``csrc/qz_common.cuh``
(design and summation order are described there).  It is compiled with
``nvcc`` at first use into ``build/repro_torch/`` of the checkout, as a
shared library with a plain C interface, and bound with ``ctypes``.

One body, three weight sources: ``qz_sample_*`` regenerate the weights
from f32 scores, u8/u16 words or a packed codec's uint32 lanes
(streaming); ``qz_resident_matmul`` reads them from a reconstructed
leaf (load); ``qz_cached_matmul`` from the hot-block tile pool where a
block has a slot and regenerates the rest (cached).  The last two serve
B=1 as a batch of one, as the JAX package's engines do.
``qz_fill_tiles`` writes pool tiles.  The JAX package computes the resident and cached contractions
and the fill in jnp; here they are the serve kernel's, which keeps the
three modes bitwise equal on the card.

``serve_plan`` works out the launch geometry (tile columns, walk chunk,
shared memory, grid) and the exact multiply-and-shift divisions the
kernel uses; the C entry takes what it returns, and a per-call scratch
for the group's mask bits.

The wrappers take CUDA tensors and launch the kernel, or raise; given a
CPU tensor they run the plain torch version
(``kernels.ops.serve_contract_plain``, ``fill_tiles_plain``).  Each
wrapper counts its launches in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..core.qspec import QSpec, sigma_f32
from ..comm.bitpack import packed_word_len, words_per_lane
from ..core.sampling import as_word
from .nvcc import SMEM_MAX, KernelLibrary, magic_div, raise_on
from .ops import (SERVE_BM, fill_tiles_plain, serve_block_grid,
                  serve_contract_plain)

MAX_BATCH = 128  # the walk keeps a sum per (batch row, column) in shared memory
MAX_ROWS = 1 << 31  # the kernel's row arithmetic is uint32

# The geometry's constants (csrc/qz_decode.cu): threads of a CTA, the
# degree whose drawn edges a warp deals out and its scratch (per warp 512
# list entries and 64 row hashes), and the card.
THREADS = 256
D_DEALT = 8
REGEN_BYTES = 4 * (THREADS // 32) * (32 * 2 * D_DEALT + 64)
SMS = 132  # H100 SXM
SMEM_SM = 233_472  # shared memory of an SM (228 KB), 1 KB of it a CTA's
CTAS_SM = 4  # CTAs an SM holds at 64 registers a thread (the launch asks the card)
TILE_MAX = 8192  # weights of a tile: 32 KB, so 4 CTAs fit an SM
CO_MAX = 8  # tile columns
TARGET_TILES = CTAS_SM * SMS  # a tile for every CTA
WALK_BYTES = 16384  # a walk step's staged x
CHUNK_MAX = 512

LAUNCHES: Dict[str, int] = {name: 0 for name in (
    "qz_sample_matmul", "qz_sample_matvec", "qz_resident_matmul",
    "qz_cached_matmul", "qz_fill_tiles")}

# the weight sources of csrc/qz_decode.cu
SRC_REGEN, SRC_RESIDENT, SRC_CACHED = 0, 1, 2
_DTYPE = {None: torch.float32, 8: torch.uint8, 16: torch.uint16}


def word_kind(qbits: Optional[int], qpacked: bool = False) -> int:
    """The operand kind of csrc/qz_common.cuh: KIND_F32, KIND_U8,
    KIND_U16, or packed lanes KIND_P4, KIND_P2, KIND_PB (any b)."""
    if qpacked:
        words_per_lane(int(qbits))  # b in [1, 16]
        return {4: 3, 2: 4}.get(int(qbits), 5)
    if qbits not in _DTYPE:
        raise ValueError(f"{qbits}-bit words are carried packed: pass "
                         "qpacked=True with the uint32 lanes")
    return {None: 0, 8: 1, 16: 2}[qbits]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class ServePlan(NamedTuple):
    """Launch geometry of one serve call (see csrc/qz_decode.cu)."""

    co: int  # output columns of a tile, a power of two
    tiles: int  # ceil(d_out / co): the units the CTAs take in turn
    rows: int  # d_in rounded up to 8: a tile's rows in shared memory
    chunk: int  # input rows of x a walk step stages, a multiple of 8
    smem: int  # dynamic shared memory of a CTA, bytes
    ctas: int  # the grid: the CTAs the card holds at this shared memory
    all_flush: bool  # d_out >= bm: every input row flushes
    bpw: int  # canonical blocks per window
    div_rpw: Tuple[int, int, int]  # magic_div(rows_per_window)
    div_bm: Tuple[int, int, int]  # magic_div(bm)


@functools.lru_cache(maxsize=None)
def serve_plan(d_in: int, d_out: int, B: int, d: int, rows_per_window: int,
               bm: int) -> ServePlan:
    """The serve kernel's launch geometry for a (d_in, d_out) group at
    batch B and degree d.

    The launch is cooperative: one CTA per slot of the card (``ctas``,
    as the kernel's shared memory allows; the launch itself asks the card).
    After drawing the group's mask bits the CTAs take tiles of ``co``
    output columns, all d_in rows, from a counter: ``co`` is the widest
    power of two up to ``CO_MAX`` that still gives ``TARGET_TILES`` tiles
    of at most ``TILE_MAX`` weights (1 for narrow shapes).  A tile's walk
    stages x (and, below bm, each row's flush flag) in chunks of
    ``chunk`` rows."""
    if not (d_in >= 1 and d_out >= 1 and 1 <= B <= MAX_BATCH and d >= 1
            and rows_per_window >= 1 and bm >= 1):
        raise ValueError(f"no serve plan for d_in={d_in}, d_out={d_out}, "
                         f"B={B}, d={d}, rows_per_window={rows_per_window}, "
                         f"bm={bm}")
    rows = -(-d_in // 8) * 8
    co = 1
    while (2 * co <= CO_MAX and -(-d_out // (2 * co)) >= TARGET_TILES
           and rows * 2 * co <= TILE_MAX):
        co *= 2
    chunk = min(CHUNK_MAX, rows,
                max(8, (WALK_BYTES // 4 - 2 * B * co) // B // 8 * 8))
    walk = 4 * (B * chunk + 2 * B * co) + co * chunk
    regen = REGEN_BYTES if d == D_DEALT else 0
    smem = 4 * co * (rows + 4) + max(regen, walk)
    if smem > SMEM_MAX:
        raise ValueError(f"the serve kernel needs {smem} B of shared memory "
                         f"a CTA at d_in={d_in}, d_out={d_out}, B={B}; the "
                         f"card gives {SMEM_MAX}")
    ctas = SMS * min(CTAS_SM, SMEM_SM // (smem + 1024))
    return ServePlan(co, -(-d_out // co), rows, chunk, smem, ctas,
                     d_out >= bm, -(-rows_per_window // bm),
                     magic_div(rows_per_window), magic_div(bm))


class _Consts(ctypes.Structure):
    """ServeConsts of csrc/qz_decode.cu: a group's constants at a batch
    size, made once (``_consts``) and passed by pointer."""

    _fields_ = [("kind", ctypes.c_int), ("seed", ctypes.c_uint),
                ("tensor_id", ctypes.c_uint), ("window", ctypes.c_int),
                ("rows_per_window", ctypes.c_uint), ("d", ctypes.c_int),
                ("sigma", ctypes.c_float), ("d_in", ctypes.c_int),
                ("d_out", ctypes.c_int)] + [
        (name, ctypes.c_uint) for name in (
            "bpw", "rpw_m", "rpw_s1", "rpw_s2", "bm_m", "bm_s1", "bm_s2")] + [
        (name, ctypes.c_int) for name in (
            "co", "rows", "chunk", "smem", "all_flush", "src", "qbits")]


_CONSTS: Dict[tuple, tuple] = {}  # (id(spec), dims...) -> (spec, _Consts)


def _consts(spec: QSpec, d_in: int, d_out: int, B: int, qbits, bm: int,
            qpacked: bool = False, src: int = SRC_REGEN):
    """The group's _Consts at batch B for a weight source, made once per
    spec object (kept with it, so the id stays that spec's)."""
    key = (id(spec), d_in, d_out, B, qbits, bm, qpacked, src)
    hit = _CONSTS.get(key)
    if hit is None or hit[0] is not spec:
        # a resident launch reads no words: its kind is a placeholder
        kind = 0 if src == SRC_RESIDENT else word_kind(qbits, qpacked)
        plan = serve_plan(d_in, d_out, B, spec.d, spec.rows_per_window, bm)
        hit = _CONSTS[key] = (spec, _Consts(
            kind, spec.seed & 0xFFFFFFFF, spec.tensor_id, spec.window,
            spec.rows_per_window, spec.d, sigma_f32(spec), d_in, d_out,
            plan.bpw, *plan.div_rpw, *plan.div_bm, plan.co, plan.rows,
            plan.chunk, plan.smem, int(plan.all_flush), src,
            int(qbits or 0)))
    return hit[1]


def _bind(lib: ctypes.CDLL) -> None:
    P, I, U, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_float)
    C = ctypes.POINTER(_Consts)
    lib.qz_serve_matmul.argtypes = [P, U, P, P, I, U, U, U, P, C, P, P, P,
                                    U, P]
    lib.qz_serve_matmul.restype = I
    lib.qz_serve_grid.argtypes = [C, ctypes.POINTER(I)]
    lib.qz_serve_grid.restype = I
    lib.qz_edges.argtypes = [P, I, I, U, P, I, U, U, I, U, I, F, P, P, P,
                             P, P]
    lib.qz_edges.restype = I
    lib.qz_gauss_check.argtypes = [P, P]
    lib.qz_gauss_check.restype = I
    lib.qz_fill_tiles.argtypes = [P, I, I, U, P, P, I, U, U, I, U, I, F, U,
                                  U, U, U, P, P]
    lib.qz_fill_tiles.restype = I


LIBRARY = KernelLibrary("qz_decode.cu", ("qz_common.cuh",), _bind)


def build() -> ctypes.CDLL:
    """Compile (once per source digest) and load the kernel library."""
    return LIBRARY.load()


def _check_words(spec: QSpec, p: torch.Tensor, qbits,
                 qpacked: bool = False) -> None:
    word_kind(qbits, qpacked)
    if spec.m >= MAX_ROWS:
        raise ValueError(f"spec has m={spec.m} rows; the kernel takes "
                         f"fewer than {MAX_ROWS}")
    if qpacked:  # uint32 lanes (or their int32 view)
        n, ok = packed_word_len(spec.n, int(qbits)), p.dtype in (
            torch.uint32, torch.int32)
        want = "uint32"
    else:
        n, ok, want = spec.n, p.dtype == _DTYPE[qbits], _DTYPE[qbits]
    if not ok or p.ndim != 1 or p.shape[0] != n:
        raise ValueError(f"score operand must be ({n},) {want}, got "
                         f"{tuple(p.shape)} {p.dtype}")
    if not p.is_contiguous():
        raise ValueError("score operand must be contiguous")


def _launch(spec: QSpec, X, row_offset, d_in, d_out, bm, src, p=None,
            step=0, qbits=None, qpacked=False, W=None, pool=None,
            slots=None):
    """One launch of the serve body with weight source ``src``."""
    dev = X.device
    operands = ((W,) if src == SRC_RESIDENT else (p,) if src == SRC_REGEN
                else (p, pool, slots))
    if not X.is_cuda or any(t.device != dev for t in operands):
        raise ValueError("the serve kernel takes CUDA tensors on one device")
    B = X.shape[0]
    if X.dtype != torch.float32 or X.shape[1] != d_in:
        raise ValueError(f"X must be (B, {d_in}) float32, got "
                         f"{tuple(X.shape)} {X.dtype}")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"batch {B} outside [1, {MAX_BATCH}]")
    if spec.shard_count != 1 or row_offset + d_in * d_out > spec.m:
        raise ValueError(f"group rows [{row_offset}, "
                         f"{row_offset + d_in * d_out}) do not fit the spec")
    if src == SRC_RESIDENT:
        if spec.m >= MAX_ROWS:
            raise ValueError(f"spec has m={spec.m} rows; the kernel takes "
                             f"fewer than {MAX_ROWS}")
        if W.dtype != torch.float32 or W.numel() != spec.m:
            raise ValueError(f"W must hold the leaf's {spec.m} float32 "
                             f"weights, got {tuple(W.shape)} {W.dtype}")
        W = W.contiguous()
    else:
        _check_words(spec, p, qbits, qpacked)
    if src == SRC_CACHED:
        _, nblk, _ = serve_block_grid(spec, bm, row_offset, d_in * d_out)
        if (pool.dtype != torch.float32 or pool.ndim != 2
                or pool.shape[1] != bm or slots.shape != (nblk,)):
            raise ValueError(f"pool must be (S, {bm}) float32 and slots "
                             f"({nblk},), got {tuple(pool.shape)} "
                             f"{pool.dtype} and {tuple(slots.shape)}")
        pool = pool.contiguous()
        slots = slots.to(torch.int32).contiguous()
    consts = _consts(spec, d_in, d_out, B, qbits, bm, qpacked, src)
    rpw = spec.rows_per_window
    w0 = row_offset // rpw  # the group's windows, whose bits phase 1 draws
    n_coords = ((row_offset + d_in * d_out - 1) // rpw + 1 - w0) * spec.window
    lib = build()
    X = X.contiguous()
    # Y, then the scratch: the group's mask bits and the tile counter
    buf = torch.empty(B * d_out + -(-n_coords // 32) + 1,
                      dtype=torch.float32, device=dev)
    rc = lib.qz_serve_matmul(
        None if p is None else p.data_ptr(), as_word(step), X.data_ptr(),
        buf.data_ptr(), B, row_offset, w0, n_coords,
        buf.data_ptr() + 4 * B * d_out, consts,
        None if W is None else W.data_ptr(),
        None if pool is None else pool.data_ptr(),
        None if slots is None else slots.data_ptr(), bm,
        torch._C._cuda_getCurrentRawStream(X.get_device()))
    raise_on(rc, "qz_serve_matmul")
    return buf[:B * d_out].view(B, d_out)


def launch_grid(spec: QSpec, d_in: int, d_out: int, B: int,
                qbits: Optional[int] = None, bm: int = SERVE_BM) -> int:
    """The CTAs a serve launch of this group at batch B takes on the
    current card (a report; the launch asks the card itself)."""
    ctas = ctypes.c_int(0)
    raise_on(build().qz_serve_grid(_consts(spec, d_in, d_out, B, qbits, bm),
                                   ctypes.byref(ctas)), "qz_serve_grid")
    return ctas.value


def _count(name: str, Y):
    LAUNCHES[name] += 1
    return Y


def qz_sample_matmul(spec: QSpec, p: torch.Tensor, step, X: torch.Tensor, *,
                     row_offset: int = 0, d_in: int, d_out: int,
                     qbits: Optional[int] = None, qpacked: bool = False,
                     bm: int = SERVE_BM) -> torch.Tensor:
    """Streamed serve matmul: score operand + X (B, d_in) -> (B, d_out).

    ``p``: the operand of ``ops.serve_operand`` (clipped f32
    probabilities, uint8/uint16 words with ``qbits``, or with
    ``qpacked`` a packed codec's uint32 lanes); ``step`` the draw word;
    rows [row_offset, row_offset + d_in*d_out) of the spec.
    """
    if not X.is_cuda:
        return serve_contract_plain(spec, p, step, X, row_offset, d_in,
                                    d_out, qbits, bm, qpacked=qpacked)
    return _count("qz_sample_matmul", _launch(
        spec, X, row_offset, d_in, d_out, bm, SRC_REGEN, p, step, qbits,
        qpacked))


def qz_sample_matvec(spec: QSpec, p: torch.Tensor, step, x: torch.Tensor, *,
                     row_offset: int = 0, d_in: int, d_out: int,
                     qbits: Optional[int] = None, qpacked: bool = False,
                     bm: int = SERVE_BM) -> torch.Tensor:
    """Streamed serve matvec: x (d_in,) -> (d_out,); the matmul kernel at
    B=1, so it equals ``qz_sample_matmul`` on ``x[None]`` bit for bit."""
    if not x.is_cuda:
        return serve_contract_plain(spec, p, step, x[None], row_offset,
                                    d_in, d_out, qbits, bm,
                                    qpacked=qpacked)[0]
    return _count("qz_sample_matvec", _launch(
        spec, x[None], row_offset, d_in, d_out, bm, SRC_REGEN, p, step,
        qbits, qpacked)[0])


def qz_resident_matmul(spec: QSpec, W: torch.Tensor, X: torch.Tensor, *,
                       row_offset: int = 0, d_in: int, d_out: int,
                       bm: int = SERVE_BM) -> torch.Tensor:
    """Load-mode serve matmul: the weights read from the reconstructed
    leaf ``W`` (m float32) through the same walk; X (B, d_in) -> (B,
    d_out)."""
    if not X.is_cuda:
        return serve_contract_plain(spec, None, 0, X, row_offset, d_in,
                                    d_out, None, bm, W=W)
    return _count("qz_resident_matmul", _launch(
        spec, X, row_offset, d_in, d_out, bm, SRC_RESIDENT, W=W))


def qz_cached_matmul(spec: QSpec, p: torch.Tensor, step, X: torch.Tensor,
                     pool: torch.Tensor, slots: torch.Tensor, *,
                     row_offset: int = 0, d_in: int, d_out: int,
                     qbits: Optional[int] = None, qpacked: bool = False,
                     bm: int = SERVE_BM) -> torch.Tensor:
    """Cached-mode serve matmul: a weight whose canonical block has a
    slot (``slots``, the group's (nblk,) map) is read from ``pool`` (S,
    bm), the others regenerated as ``qz_sample_matmul`` does."""
    if not X.is_cuda:
        return serve_contract_plain(spec, p, step, X, row_offset, d_in,
                                    d_out, qbits, bm, qpacked=qpacked,
                                    pool=pool, slots=slots)
    return _count("qz_cached_matmul", _launch(
        spec, X, row_offset, d_in, d_out, bm, SRC_CACHED, p, step, qbits,
        qpacked, pool=pool, slots=slots))


def qz_fill_tiles(spec: QSpec, p: torch.Tensor, step, groups_idx: torch.Tensor,
                  blocks: torch.Tensor, *, qbits: Optional[int] = None,
                  qpacked: bool = False, bm: int = SERVE_BM) -> torch.Tensor:
    """The hot-block cache's fill: T (group, canonical block) pairs ->
    (T, bm) float32 tiles, each weight as the plain path computes it (the
    sign of zero included), +0 at dead lanes; a CTA a tile."""
    from .ops import serve_group_dims

    if not p.is_cuda:
        return fill_tiles_plain(spec, p, step, groups_idx, blocks, qbits,
                                qpacked, bm)
    _check_words(spec, p, qbits, qpacked)
    _, d_in, d_out = serve_group_dims(spec)
    g = groups_idx.to(device=p.device, dtype=torch.int32).contiguous()
    t = blocks.to(device=p.device, dtype=torch.int32).contiguous()
    T = g.numel()
    out = torch.empty((T, bm), dtype=torch.float32, device=p.device)
    rc = build().qz_fill_tiles(
        p.data_ptr(), word_kind(qbits, qpacked), int(qbits or 0),
        as_word(step), g.data_ptr(), t.data_ptr(), T,
        spec.seed & 0xFFFFFFFF, spec.tensor_id, spec.window,
        spec.rows_per_window, spec.d, sigma_f32(spec), d_in * d_out, spec.m,
        bm, max(1, -(-spec.rows_per_window // bm)), out.data_ptr(),
        torch.cuda.current_stream(p.device).cuda_stream)
    raise_on(rc, "qz_fill_tiles")
    return _count("qz_fill_tiles", out)


def gauss_check(device) -> Tuple[int, int, int, int]:
    """The kernels' logf, sqrtf, cosf and Box-Muller (``qz_common.cuh``)
    against the library's at every 24-bit uniform a draw can give: the
    numbers of arguments where each differs in any bit (all 0 expected)."""
    out = torch.zeros(4, dtype=torch.int64, device=device)
    raise_on(build().qz_gauss_check(
        out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream),
        "qz_gauss_check")
    return tuple(int(v) for v in out.tolist())


def qz_edges(spec: QSpec, p: torch.Tensor, step, rows: torch.Tensor,
             qbits: Optional[int] = None, qpacked: bool = False):
    """The kernel's device functions at the given flat rows (a check, not
    a serving path): (idx (R, d) int32, bits (R, d) uint8, vals (R, d)
    f32, w (R,) f32)."""
    if not (p.is_cuda and rows.is_cuda):
        raise ValueError("qz_edges takes CUDA tensors")
    _check_words(spec, p, qbits, qpacked)
    rows = rows.to(torch.int64).contiguous()
    R = rows.numel()
    dev = rows.device
    idx = torch.empty((R, spec.d), dtype=torch.int32, device=dev)
    bits = torch.empty((R, spec.d), dtype=torch.uint8, device=dev)
    vals = torch.empty((R, spec.d), dtype=torch.float32, device=dev)
    w = torch.empty((R,), dtype=torch.float32, device=dev)
    if R:
        rc = build().qz_edges(
            p.data_ptr(), word_kind(qbits, qpacked), int(qbits or 0),
            as_word(step), rows.data_ptr(), R, spec.seed & 0xFFFFFFFF,
            spec.tensor_id, spec.window, spec.rows_per_window, spec.d,
            sigma_f32(spec), idx.data_ptr(), bits.data_ptr(),
            vals.data_ptr(), w.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        raise_on(rc, "qz_edges")
    return idx, bits, vals, w
