"""The training CUDA kernels for Hopper (sm_90a), and wrappers.

Replaces ten Pallas kernels of the JAX package's
``kernels/qz_reconstruct.py``:

- ``qz_sample_reconstruct_batched_fwd`` (the fused round's forward) and
  ``qz_sample_reconstruct_fwd`` (its K=1 entry: local sample-mode
  training, ``evaluate`` off the u8 carry) — ``sample_reconstruct_kernel``;
- ``qz_reconstruct_batched_fwd`` (the composed round's forward) and
  ``qz_reconstruct_fwd`` (its K=1 entry: continuous-mode training, the
  expected and discretized networks) — ``mask_reconstruct_kernel``, the
  same row code reading an explicit operand in place of a draw;
- ``qz_reconstruct_batched_bwd_plan`` (the round's backward) —
  ``plan_bwd_kernel``, on the plan of either order; and
  ``qz_reconstruct_bwd_plan`` (its K=1 entry: every local backward) —
  ``plan_bwd_one_kernel``, on the plan's compact layout
  (``core.transpose_plan.build_plan_layout``);
- ``qz_reconstruct_batched_bwd`` (the scatter transpose, the round's
  backward under ``REPRO_BWD_PLAN=scatter``) — ``scatter_bwd_kernel``,
  which regenerates Q and reads no plan, and equals ``plan_bwd_kernel``
  on the canonical plan bit for bit; and ``qz_reconstruct_bwd`` (its K=1
  entry: the local backward under scatter) — ``scatter_bwd_one_kernel``,
  the same sums sized for one client's windows;
- ``qz_sample_pack_batched_fwd`` (the round's upload) —
  ``sample_pack_kernel``; and ``qz_sample_pack_fwd`` (its K=1 entry:
  each rank's upload in the sharded round), its draw word a scalar
  argument.

The other K=1 forms are the batched kernel at K=1 behind their own
wrapper and launch counter.  The two one-client backward kernels take a
leaf's launch constants by pointer, made once per (spec, device, order)
from ``scatter_one_plan`` / ``plan_one_plan`` (their launch geometry);
kernel 5's hold the compact plan layout it reads, so the card keeps no
padded plan for a one-client backward (``clear_caches`` drops them).

The source is ``csrc/qz_reconstruct.cu`` (design, bound and summation
order are described there), built by ``kernels.nvcc`` at first use.
Given CUDA tensors a wrapper launches its kernel, checks the launch and
counts it in ``LAUNCHES``, or raises; nothing falls back.  Given CPU
tensors it runs the kernel's plain torch version in ``kernels.ops``,
which computes the same elementwise operations in the same order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..core.qspec import QSpec, sigma_f32
from ..core.sampling import as_word
from ..core.transpose_plan import (PlanLayout, build_plan_layout,
                                   build_transpose_plan)
from .nvcc import KernelLibrary, magic_div, raise_on, source_constant

MAX_K = 1024
MAX_ROWS = 1 << 31  # row and coordinate arithmetic is uint32

# The one-client backward kernels' geometry: the scatter's threads (the
# kernel's own constant), the edges of a pass and the words its
# coordinates' row masks may take (so a window holds at most
# S1_MASK_WORDS coordinates); the plan walk's threads, the slab entries a
# CTA stages at once, and the most cotangent rows it stages.
S1_THREADS = source_constant("qz_reconstruct.cu", "S1_THREADS")
S1_EDGES = 2048
S1_MASK_WORDS = 8192
P1_THREADS = source_constant("qz_reconstruct.cu", "P1_THREADS")
P1_PIECE_MAX = 16384
P1_STAGE_G_MAX = 8192

LAUNCHES: Dict[str, int] = {
    "qz_sample_reconstruct_batched_fwd": 0,
    "qz_sample_reconstruct_fwd": 0,
    "qz_reconstruct_batched_bwd_plan": 0,
    "qz_sample_pack_batched_fwd": 0,
    "qz_reconstruct_batched_fwd": 0,
    "qz_reconstruct_fwd": 0,
    "qz_reconstruct_bwd_plan": 0,
    "qz_reconstruct_batched_bwd": 0,
    "qz_reconstruct_bwd": 0,
    "qz_sample_pack_fwd": 0,
}

_KIND = {None: 0, 8: 1, 16: 2}
_DTYPE = {None: torch.float32, 8: torch.uint8, 16: torch.uint16}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    P, I, U, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                     ctypes.c_longlong, ctypes.c_float)
    lib.qz_sample_reconstruct.argtypes = [P, I, P, I, L, U, U, U, I, U, I,
                                          F, P, P]
    lib.qz_sample_reconstruct.restype = I
    lib.qz_reconstruct_batched.argtypes = [P, I, L, U, U, U, I, U, I, F, P,
                                           P]
    lib.qz_reconstruct_batched.restype = I
    lib.qz_plan_bwd.argtypes = [P, P, P, I, U, U, I, I, U, P, P]
    lib.qz_plan_bwd.restype = I
    lib.qz_sample_pack.argtypes = [P, P, I, L, U, U, P, P]
    lib.qz_sample_pack.restype = I
    lib.qz_scatter_bwd.argtypes = [P, I, U, U, U, U, I, U, I, I, F, P, P]
    lib.qz_scatter_bwd.restype = I
    lib.qz_sample_pack_one.argtypes = [P, U, U, U, U, P, P]
    lib.qz_sample_pack_one.restype = I
    lib.qz_scatter_bwd_one.argtypes = [P, P, P, P]
    lib.qz_scatter_bwd_one.restype = I
    lib.qz_plan_bwd_one.argtypes = [P, P, P, P]
    lib.qz_plan_bwd_one.restype = I


LIBRARY = KernelLibrary("qz_reconstruct.cu", ("qz_common.cuh",), _bind)


def build() -> ctypes.CDLL:
    """Compile (once per source digest) and load the kernel library."""
    return LIBRARY.load()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class ScatterOnePlan(NamedTuple):
    """Launch geometry of kernel 2 at one leaf."""

    ctas: int  # one a window
    threads: int
    chunk_rows: int  # a window's rows a pass: chunk_rows * d <= S1_EDGES
    mask_stride: int  # words of a coordinate's row mask, odd, >= rows / 32
    passes: int  # passes of a full window
    smem: int  # dynamic shared memory of a CTA, bytes
    div_d: Tuple[int, int, int]  # magic_div(d)


@functools.lru_cache(maxsize=None)
def scatter_one_plan(window: int, rows_per_window: int, d: int,
                     num_windows: int) -> ScatterOnePlan:
    """Kernel 2's geometry: a CTA a window, regenerating its edges in
    passes of ``chunk_rows`` rows; shared memory holds the coordinates'
    row masks (an odd stride of words, so neighbouring coordinates' masks
    lie in different banks), the slots' mixed counters and the pass's
    rows and edge products."""
    if not (2 <= window <= S1_MASK_WORDS and window & (window - 1) == 0
            and 1 <= d <= S1_EDGES and rows_per_window >= 1
            and num_windows >= 1):
        raise ValueError(f"the one-client scatter takes a power-of-two "
                         f"window in [2, {S1_MASK_WORDS}] and d <= "
                         f"{S1_EDGES}; got window={window}, d={d}, "
                         f"rows_per_window={rows_per_window}")
    most = S1_MASK_WORDS // window - (S1_MASK_WORDS // window + 1) % 2  # odd
    chunk_rows = min(S1_EDGES // d, rows_per_window, 32 * most)
    stride = -(-chunk_rows // 32) | 1
    words = window * stride + 2 * d + 4 * chunk_rows + chunk_rows * d
    return ScatterOnePlan(num_windows, S1_THREADS, chunk_rows, stride,
                          -(-rows_per_window // chunk_rows), 4 * words,
                          magic_div(d))


class PlanOnePlan(NamedTuple):
    """Launch geometry of kernel 5 at one leaf."""

    ctas: int  # one a window
    threads: int
    piece: int  # slab entries staged at once
    passes: int  # pieces of the largest window's slab
    stage_g: bool  # the window's cotangents staged in shared memory
    smem: int  # dynamic shared memory of a CTA, bytes
    row_bytes: int  # of a layout entry's row: 2 (narrow) or 4


@functools.lru_cache(maxsize=None)
def plan_one_plan(rows_per_window: int, num_windows: int, max_slab: int,
                  narrow: bool) -> PlanOnePlan:
    """Kernel 5's geometry: a CTA a window, its slab staged a piece of
    at most ``P1_PIECE_MAX`` entries at a time (6 bytes an entry with
    narrow rows, else 8), the window's cotangents beside it where they
    fit."""
    piece = max(1, min(max_slab, P1_PIECE_MAX))
    stage_g = rows_per_window <= P1_STAGE_G_MAX
    row_bytes = 2 if narrow else 4
    smem = piece * (4 + row_bytes) + (4 * rows_per_window if stage_g else 0)
    return PlanOnePlan(num_windows, P1_THREADS, piece,
                       max(1, -(-max_slab // piece)), stage_g, smem,
                       row_bytes)


class _ScatterOneConsts(ctypes.Structure):
    """ScatterOneConsts of csrc/qz_reconstruct.cu."""

    _fields_ = [("seed", ctypes.c_uint), ("tensor_id", ctypes.c_uint),
                ("window", ctypes.c_int), ("rows_per_window", ctypes.c_uint),
                ("d", ctypes.c_int), ("sigma", ctypes.c_float)] + [
        (name, ctypes.c_uint) for name in (
            "m", "num_windows", "chunk_rows", "mask_stride", "div_m",
            "div_s1", "div_s2")] + [("smem", ctypes.c_int)]


class _PlanOneConsts(ctypes.Structure):
    """PlanOneConsts of csrc/qz_reconstruct.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "rows", "vals", "starts")] + [(name, ctypes.c_uint) for name in (
            "m", "window", "rows_per_window", "num_windows")] + [
        (name, ctypes.c_int) for name in (
            "piece", "narrow", "stage_g", "smem")]


def scatter_one_geometry(spec: QSpec) -> ScatterOnePlan:
    return scatter_one_plan(spec.window, spec.rows_per_window, spec.d,
                            spec.num_windows)


@functools.lru_cache(maxsize=64)
def _scatter_one(spec: QSpec) -> tuple:
    """Kernel 2's launch constants at a leaf: (struct, its address)."""
    _check_spec(spec)
    plan = scatter_one_geometry(spec)
    c = _ScatterOneConsts(spec.seed & 0xFFFFFFFF, spec.tensor_id,
                          spec.window, spec.rows_per_window, spec.d,
                          sigma_f32(spec), spec.m, spec.num_windows,
                          plan.chunk_rows, plan.mask_stride, *plan.div_d,
                          plan.smem)
    return c, ctypes.addressof(c)


class _PlanOne(NamedTuple):
    """Kernel 5's launch constants at a leaf on one card, holding the
    compact plan layout that ``consts`` points into."""

    layout: PlanLayout
    geometry: PlanOnePlan
    consts: _PlanOneConsts
    address: int


@functools.lru_cache(maxsize=64)
def _plan_one(spec: QSpec, device: int, order: str) -> _PlanOne:
    _check_spec(spec)
    layout = build_plan_layout(spec, torch.device("cuda", device), order)
    plan = plan_one_plan(spec.rows_per_window, spec.num_windows,
                         layout.max_slab, layout.narrow)
    c = _PlanOneConsts(layout.rows.data_ptr(), layout.vals.data_ptr(),
                       layout.starts.data_ptr(), spec.m, spec.window,
                       spec.rows_per_window, spec.num_windows, plan.piece,
                       int(layout.narrow), int(plan.stage_g), plan.smem)
    return _PlanOne(layout, plan, c, ctypes.addressof(c))


def plan_one_geometry(spec: QSpec, device,
                      order: str = "canonical") -> PlanOnePlan:
    """Kernel 5's geometry at a leaf on a card (builds its layout there)."""
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _plan_one(spec, index, order).geometry


def clear_caches() -> None:
    """Drop the one-client backward kernels' launch constants, and with
    them the compact plan layouts kernel 5 reads."""
    _scatter_one.cache_clear()
    _plan_one.cache_clear()


def _one_cotangent(spec: QSpec, g: torch.Tensor) -> torch.Tensor:
    """The (n,) output of a one-client backward, once g is a contiguous
    (m,) float32 tensor (the kernel reads m floats from its pointer)."""
    if (g.dtype != torch.float32 or g.shape != (spec.m,)
            or not g.is_contiguous()):
        raise ValueError(f"g must be contiguous ({spec.m},) float32, got "
                         f"{tuple(g.shape)} {g.dtype}")
    return g.new_empty(spec.n)


def _step_words(steps: torch.Tensor, K: int, device) -> torch.Tensor:
    """(K,) draw words: int64 holding uint32 values, on the device."""
    if (steps.dtype != torch.int64 or steps.device != device
            or tuple(steps.shape) != (K,) or not steps.is_contiguous()):
        raise ValueError(f"draw words must be a contiguous ({K},) int64 "
                         f"tensor on {device}, got {tuple(steps.shape)} "
                         f"{steps.dtype} on {steps.device}")
    return steps


def _check_spec(spec: QSpec) -> None:
    if spec.shard_count != 1:
        raise ValueError("the kernels take the single-block layout "
                         f"(shard_count=1), got {spec.shard_count}")
    if spec.m_pad >= MAX_ROWS or spec.n >= MAX_ROWS:
        raise ValueError(f"spec has m_pad={spec.m_pad}, n={spec.n}; the "
                         f"kernels take fewer than {MAX_ROWS}")


def _check_operand(spec: QSpec, P: torch.Tensor, qbits) -> int:
    if qbits not in _KIND:
        raise NotImplementedError(
            f"qbits={qbits}: the packed sub-byte carry is not ported yet")
    if P.dtype != _DTYPE[qbits] or P.ndim != 2 or P.shape[1] != spec.n:
        raise ValueError(f"operand must be (K, {spec.n}) {_DTYPE[qbits]}, "
                         f"got {tuple(P.shape)} {P.dtype}")
    if not P.is_contiguous():
        raise ValueError("operand must be contiguous")
    K = P.shape[0]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"{K} clients outside [1, {MAX_K}]")
    return K


def _launch_sample_reconstruct(spec: QSpec, P, steps, qbits):
    if not P.is_cuda:
        raise ValueError("the sample-reconstruct kernel takes CUDA tensors")
    _check_spec(spec)
    K = _check_operand(spec, P, qbits)
    words = _step_words(steps, K, P.device)
    W = torch.empty((K, spec.m), dtype=torch.float32, device=P.device)
    rc = build().qz_sample_reconstruct(
        P.data_ptr(), _KIND[qbits], words.data_ptr(), K, spec.n,
        spec.m, spec.seed & 0xFFFFFFFF, spec.tensor_id, spec.window,
        spec.rows_per_window, spec.d, sigma_f32(spec), W.data_ptr(),
        _stream(P))
    raise_on(rc, "qz_sample_reconstruct")
    return W


def qz_sample_reconstruct_batched_fwd(spec: QSpec, P: torch.Tensor,
                                      steps: torch.Tensor,
                                      qbits: Optional[int] = None):
    """W (K, m) moved flat order = Q Bern(P_k), drawn at words ``steps``
    (K,); ``P`` (K, n) clipped f32 probabilities, or u8/u16 words."""
    if not P.is_cuda:
        from .ops import sample_reconstruct_plain

        return sample_reconstruct_plain(spec, P, steps, qbits)
    W = _launch_sample_reconstruct(spec, P, steps, qbits)
    LAUNCHES["qz_sample_reconstruct_batched_fwd"] += 1
    return W


def qz_sample_reconstruct_fwd(spec: QSpec, p: torch.Tensor, step: torch.Tensor,
                              qbits: Optional[int] = None):
    """w (m,) = Q Bern(p) for one client: the batched kernel at K=1, so
    it equals a row of ``qz_sample_reconstruct_batched_fwd`` bit for bit."""
    if not p.is_cuda:
        from .ops import sample_reconstruct_plain

        return sample_reconstruct_plain(spec, p[None], step, qbits)[0]
    w = _launch_sample_reconstruct(spec, p[None], step, qbits)[0]
    LAUNCHES["qz_sample_reconstruct_fwd"] += 1
    return w


def _launch_reconstruct(spec: QSpec, Z: torch.Tensor):
    _check_spec(spec)
    K = _check_operand(spec, Z, None)
    W = torch.empty((K, spec.m), dtype=torch.float32, device=Z.device)
    rc = build().qz_reconstruct_batched(
        Z.data_ptr(), K, spec.n, spec.m, spec.seed & 0xFFFFFFFF,
        spec.tensor_id, spec.window, spec.rows_per_window, spec.d,
        sigma_f32(spec), W.data_ptr(), _stream(Z))
    raise_on(rc, "qz_reconstruct_batched")
    return W


def qz_reconstruct_batched_fwd(spec: QSpec, Z: torch.Tensor):
    """W (K, m) moved flat order = Q Z_k; ``Z`` (K, n) f32 operands
    (masks, or probabilities in continuous mode)."""
    if not Z.is_cuda:
        from .ops import reconstruct_plain

        return reconstruct_plain(spec, Z)
    W = _launch_reconstruct(spec, Z)
    LAUNCHES["qz_reconstruct_batched_fwd"] += 1
    return W


def qz_reconstruct_fwd(spec: QSpec, z: torch.Tensor):
    """w (m,) moved flat order = Q z for one operand z (n,) f32: the
    batched kernel at K=1, so it equals a row of
    ``qz_reconstruct_batched_fwd`` bit for bit."""
    if not z.is_cuda:
        from .ops import reconstruct_plain

        return reconstruct_plain(spec, z[None])[0]
    w = _launch_reconstruct(spec, z[None])[0]
    LAUNCHES["qz_reconstruct_fwd"] += 1
    return w


def _check_cotangent(spec: QSpec, G: torch.Tensor) -> torch.Tensor:
    _check_spec(spec)
    if G.dtype != torch.float32 or G.ndim != 2 or G.shape[1] != spec.m:
        raise ValueError(f"G must be (K, {spec.m}) float32, got "
                         f"{tuple(G.shape)} {G.dtype}")
    if not 1 <= G.shape[0] <= MAX_K:
        raise ValueError(f"{G.shape[0]} clients outside [1, {MAX_K}]")
    return G.contiguous()


def _launch_plan_bwd(spec: QSpec, G: torch.Tensor, order: str):
    G = _check_cotangent(spec, G)
    K = G.shape[0]
    plan = build_transpose_plan(spec, G.device, order)
    out = torch.empty((K, spec.n), dtype=torch.float32, device=G.device)
    rc = build().qz_plan_bwd(
        G.data_ptr(), plan.rows.data_ptr(), plan.vals.data_ptr(), K, spec.n,
        spec.m, plan.deg, spec.window, spec.rows_per_window, out.data_ptr(),
        _stream(G))
    raise_on(rc, "qz_plan_bwd")
    return out


def qz_reconstruct_batched_bwd_plan(spec: QSpec, G: torch.Tensor,
                                    order: str = "canonical"):
    """grad_Z (K, n) = Q^T G_k over the ``order`` transpose plan; ``G``
    (K, m) f32 cotangents in moved flat order."""
    if not G.is_cuda:
        from .ops import plan_bwd_plain

        return plan_bwd_plain(spec, G, order)
    out = _launch_plan_bwd(spec, G, order)
    LAUNCHES["qz_reconstruct_batched_bwd_plan"] += 1
    return out


def qz_reconstruct_bwd_plan(spec: QSpec, g: torch.Tensor,
                            order: str = "canonical"):
    """grad_z (n,) = Q^T g over the ``order`` transpose plan for one
    cotangent g (m,) f32 in moved flat order; equals a row of
    ``qz_reconstruct_batched_bwd_plan`` bit for bit."""
    if not g.is_cuda:
        from .ops import plan_bwd_one_plain

        return plan_bwd_one_plain(spec, g, order)
    dev = g.get_device()
    address = _plan_one(spec, dev, order).address
    out = _one_cotangent(spec, g)
    raise_on(build().qz_plan_bwd_one(
        g.data_ptr(), out.data_ptr(), address,
        torch._C._cuda_getCurrentRawStream(dev)), "qz_plan_bwd_one")
    LAUNCHES["qz_reconstruct_bwd_plan"] += 1
    return out


def _launch_scatter_bwd(spec: QSpec, G: torch.Tensor):
    G = _check_cotangent(spec, G)
    K = G.shape[0]
    out = torch.empty((K, spec.n), dtype=torch.float32, device=G.device)
    rc = build().qz_scatter_bwd(
        G.data_ptr(), K, spec.n, spec.m, spec.seed & 0xFFFFFFFF,
        spec.tensor_id, spec.window, spec.rows_per_window, spec.num_windows,
        spec.d, sigma_f32(spec), out.data_ptr(), _stream(G))
    raise_on(rc, "qz_scatter_bwd")
    return out


def qz_reconstruct_batched_bwd(spec: QSpec, G: torch.Tensor):
    """grad_Z (K, n) = Q^T G_k by the scatter, Q regenerated in the
    kernel and no plan held; ``G`` (K, m) f32 cotangents in moved flat
    order.  Equals ``qz_reconstruct_batched_bwd_plan`` on the canonical
    plan bit for bit."""
    if not G.is_cuda:
        from .ops import scatter_bwd_plain

        return scatter_bwd_plain(spec, G)
    out = _launch_scatter_bwd(spec, G)
    LAUNCHES["qz_reconstruct_batched_bwd"] += 1
    return out


def qz_reconstruct_bwd(spec: QSpec, g: torch.Tensor):
    """grad_z (n,) = Q^T g by the scatter for one cotangent g (m,) f32
    in moved flat order; equals a row of ``qz_reconstruct_batched_bwd``
    bit for bit."""
    if not g.is_cuda:
        from .ops import scatter_bwd_one_plain

        return scatter_bwd_one_plain(spec, g)
    address = _scatter_one(spec)[1]
    out = _one_cotangent(spec, g)
    raise_on(build().qz_scatter_bwd_one(
        g.data_ptr(), out.data_ptr(), address,
        torch._C._cuda_getCurrentRawStream(g.get_device())),
        "qz_scatter_bwd_one")
    LAUNCHES["qz_reconstruct_bwd"] += 1
    return out


def qz_sample_pack_batched_fwd(spec: QSpec, P: torch.Tensor,
                               steps: torch.Tensor):
    """Upload lanes (K, ceil(n/32)) int64 holding uint32 of Bern(P_k),
    ``comm.bitpack.pack_mask``'s layout; ``P`` (K, n) f32 probabilities."""
    if not P.is_cuda:
        from .ops import sample_pack_plain

        return sample_pack_plain(spec, P, steps)
    _check_spec(spec)
    K = _check_operand(spec, P, None)
    words = _step_words(steps, K, P.device)
    out = torch.empty((K, (spec.n + 31) // 32), dtype=torch.int64,
                      device=P.device)
    rc = build().qz_sample_pack(
        P.data_ptr(), words.data_ptr(), K, spec.n, spec.seed & 0xFFFFFFFF,
        spec.tensor_id, out.data_ptr(), _stream(P))
    raise_on(rc, "qz_sample_pack")
    LAUNCHES["qz_sample_pack_batched_fwd"] += 1
    return out


def qz_sample_pack_fwd(spec: QSpec, p: torch.Tensor, step: int):
    """Upload lanes (ceil(n/32),) int64 holding uint32 of Bern(p) for one
    client, drawn at the scalar word ``step``; ``p`` (n,) contiguous f32
    probabilities.  The bits of ``qz_sample_pack_batched_fwd``'s row at
    the same probabilities and word."""
    if not p.is_cuda:
        from .ops import sample_pack_one_plain

        return sample_pack_one_plain(spec, p, step)
    _check_spec(spec)
    if (p.dtype != torch.float32 or tuple(p.shape) != (spec.n,)
            or not p.is_contiguous()):
        raise ValueError(f"p must be contiguous ({spec.n},) float32, got "
                         f"{tuple(p.shape)} {p.dtype}")
    out = torch.empty(((spec.n + 31) // 32,), dtype=torch.int64,
                      device=p.device)
    rc = build().qz_sample_pack_one(
        p.data_ptr(), as_word(step), spec.n, spec.seed & 0xFFFFFFFF,
        spec.tensor_id, out.data_ptr(), _stream(p))
    raise_on(rc, "qz_sample_pack_one")
    LAUNCHES["qz_sample_pack_fwd"] += 1
    return out
