"""Streamed serve matmul/matvec as a CUDA kernel for Hopper (sm_90a).

Replaces the Pallas kernels ``qz_sample_matmul`` and ``qz_sample_matvec``
of the JAX package's ``kernels/qz_decode.py``.  The source is
``csrc/qz_decode.cu`` with its device functions in ``csrc/qz_common.cuh``
(design and summation order are described there).  It is compiled with
``nvcc`` at first use into ``build/repro_torch/`` of the checkout, as a
shared library with a plain C interface, and bound with ``ctypes``.

``serve_plan`` works out the launch geometry (tile columns, walk chunk,
shared memory, grid) and the exact multiply-and-shift divisions the
kernel uses; the C entry takes what it returns, and a per-call scratch
for the group's mask bits.

The wrappers take CUDA tensors and launch the kernel, or raise; given a
CPU tensor they run the plain torch version
(``kernels.ops.serve_contract_plain``).  Each wrapper counts its
launches in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..core.qspec import QSpec, sigma_f32
from ..core.sampling import as_word
from .nvcc import SMEM_MAX, KernelLibrary, magic_div, raise_on
from .ops import SERVE_BM, serve_contract_plain

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

LAUNCHES: Dict[str, int] = {"qz_sample_matmul": 0, "qz_sample_matvec": 0}

_KIND = {None: 0, 8: 1, 16: 2}
_DTYPE = {None: torch.float32, 8: torch.uint8, 16: torch.uint16}


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
            "co", "rows", "chunk", "smem", "all_flush")]


_CONSTS: Dict[tuple, tuple] = {}  # (id(spec), dims...) -> (spec, _Consts)


def _consts(spec: QSpec, d_in: int, d_out: int, B: int, qbits, bm: int):
    """The group's _Consts at batch B, made once per spec object (kept
    with it, so the id stays that spec's)."""
    key = (id(spec), d_in, d_out, B, qbits, bm)
    hit = _CONSTS.get(key)
    if hit is None or hit[0] is not spec:
        hit = _CONSTS[key] = (spec, _make_consts(spec, d_in, d_out, B, qbits,
                                                 bm))
    return hit[1]


def _make_consts(spec: QSpec, d_in: int, d_out: int, B: int, qbits, bm: int):
    plan = serve_plan(d_in, d_out, B, spec.d, spec.rows_per_window, bm)
    return _Consts(_KIND[qbits], spec.seed & 0xFFFFFFFF, spec.tensor_id,
                   spec.window, spec.rows_per_window, spec.d,
                   sigma_f32(spec), d_in, d_out, plan.bpw, *plan.div_rpw,
                   *plan.div_bm, plan.co, plan.rows, plan.chunk, plan.smem,
                   int(plan.all_flush))


def _bind(lib: ctypes.CDLL) -> None:
    P, I, U, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_float)
    C = ctypes.POINTER(_Consts)
    lib.qz_serve_matmul.argtypes = [P, U, P, P, I, U, U, U, P, C, P]
    lib.qz_serve_matmul.restype = I
    lib.qz_serve_grid.argtypes = [C, ctypes.POINTER(I)]
    lib.qz_serve_grid.restype = I
    lib.qz_edges.argtypes = [P, I, U, P, I, U, U, I, U, I, F, P, P, P, P,
                             P]
    lib.qz_edges.restype = I
    lib.qz_gauss_check.argtypes = [P, P]
    lib.qz_gauss_check.restype = I


LIBRARY = KernelLibrary("qz_decode.cu", ("qz_common.cuh",), _bind)


def build() -> ctypes.CDLL:
    """Compile (once per source digest) and load the kernel library."""
    return LIBRARY.load()


def _check_words(spec: QSpec, p: torch.Tensor, qbits) -> None:
    if qbits not in _KIND:
        raise NotImplementedError(
            f"qbits={qbits}: the packed sub-byte carry is not ported yet")
    if spec.m >= MAX_ROWS:
        raise ValueError(f"spec has m={spec.m} rows; the kernel takes "
                         f"fewer than {MAX_ROWS}")
    if p.dtype != _DTYPE[qbits] or p.ndim != 1 or p.shape[0] != spec.n:
        raise ValueError(f"score operand must be ({spec.n},) "
                         f"{_DTYPE[qbits]}, got {tuple(p.shape)} {p.dtype}")
    if not p.is_contiguous():
        raise ValueError("score operand must be contiguous")


def _launch(spec: QSpec, p, step, X, row_offset, d_in, d_out, qbits, bm):
    if not (p.is_cuda and X.is_cuda and p.device == X.device):
        raise ValueError("the serve kernel takes CUDA tensors on one device")
    _check_words(spec, p, qbits)
    B = X.shape[0]
    if X.dtype != torch.float32 or X.shape[1] != d_in:
        raise ValueError(f"X must be (B, {d_in}) float32, got "
                         f"{tuple(X.shape)} {X.dtype}")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"batch {B} outside [1, {MAX_BATCH}]")
    if spec.shard_count != 1 or row_offset + d_in * d_out > spec.m:
        raise ValueError(f"group rows [{row_offset}, "
                         f"{row_offset + d_in * d_out}) do not fit the spec")
    consts = _consts(spec, d_in, d_out, B, qbits, bm)
    rpw = spec.rows_per_window
    w0 = row_offset // rpw  # the group's windows, whose bits phase 1 draws
    n_coords = ((row_offset + d_in * d_out - 1) // rpw + 1 - w0) * spec.window
    lib = build()
    X = X.contiguous()
    # Y, then the scratch: the group's mask bits and the tile counter
    buf = torch.empty(B * d_out + -(-n_coords // 32) + 1,
                      dtype=torch.float32, device=X.device)
    rc = lib.qz_serve_matmul(
        p.data_ptr(), as_word(step), X.data_ptr(), buf.data_ptr(), B,
        row_offset, w0, n_coords, buf.data_ptr() + 4 * B * d_out, consts,
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


def qz_sample_matmul(spec: QSpec, p: torch.Tensor, step, X: torch.Tensor, *,
                     row_offset: int = 0, d_in: int, d_out: int,
                     qbits: Optional[int] = None,
                     bm: int = SERVE_BM) -> torch.Tensor:
    """Streamed serve matmul: score operand + X (B, d_in) -> (B, d_out).

    ``p``: the (n,) operand of ``ops.serve_operand`` (clipped f32
    probabilities, or uint8/uint16 words with ``qbits``); ``step`` the
    draw word; rows [row_offset, row_offset + d_in*d_out) of the spec.
    """
    if not X.is_cuda:
        return serve_contract_plain(spec, p, step, X, row_offset, d_in,
                                    d_out, qbits, bm)
    Y = _launch(spec, p, step, X, row_offset, d_in, d_out, qbits, bm)
    LAUNCHES["qz_sample_matmul"] += 1
    return Y


def qz_sample_matvec(spec: QSpec, p: torch.Tensor, step, x: torch.Tensor, *,
                     row_offset: int = 0, d_in: int, d_out: int,
                     qbits: Optional[int] = None,
                     bm: int = SERVE_BM) -> torch.Tensor:
    """Streamed serve matvec: x (d_in,) -> (d_out,); the matmul kernel at
    B=1, so it equals ``qz_sample_matmul`` on ``x[None]`` bit for bit."""
    if not x.is_cuda:
        return serve_contract_plain(spec, p, step, x[None], row_offset,
                                    d_in, d_out, qbits, bm)[0]
    y = _launch(spec, p, step, x[None], row_offset, d_in, d_out, qbits, bm)
    LAUNCHES["qz_sample_matvec"] += 1
    return y[0]


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
             qbits: Optional[int] = None):
    """The kernel's device functions at the given flat rows (a check, not
    a serving path): (idx (R, d) int32, bits (R, d) uint8, vals (R, d)
    f32, w (R,) f32)."""
    if not (p.is_cuda and rows.is_cuda):
        raise ValueError("qz_edges takes CUDA tensors")
    _check_words(spec, p, qbits)
    rows = rows.to(torch.int64).contiguous()
    R = rows.numel()
    dev = rows.device
    idx = torch.empty((R, spec.d), dtype=torch.int32, device=dev)
    bits = torch.empty((R, spec.d), dtype=torch.uint8, device=dev)
    vals = torch.empty((R, spec.d), dtype=torch.float32, device=dev)
    w = torch.empty((R,), dtype=torch.float32, device=dev)
    if R:
        rc = build().qz_edges(
            p.data_ptr(), _KIND[qbits], as_word(step),
            rows.data_ptr(), R, spec.seed & 0xFFFFFFFF, spec.tensor_id,
            spec.window, spec.rows_per_window, spec.d, sigma_f32(spec),
            idx.data_ptr(), bits.data_ptr(), vals.data_ptr(), w.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        raise_on(rc, "qz_edges")
    return idx, bits, vals, w

