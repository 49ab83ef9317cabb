"""The training CUDA kernels for Hopper (sm_90a), and wrappers.

Replaces ten Pallas kernels of the JAX package's
``kernels/qz_reconstruct.py``:

- ``qz_sample_reconstruct_batched_fwd`` (the fused round's forward) and
  ``qz_sample_reconstruct_fwd`` (its K=1 entry: local sample-mode
  training, ``evaluate`` off the u8 carry) —
  ``sample_reconstruct_window_kernel``;
- ``qz_reconstruct_batched_fwd`` (the composed round's forward) and
  ``qz_reconstruct_fwd`` (its K=1 entry: continuous-mode training, the
  expected and discretized networks) — ``mask_reconstruct_window_kernel``,
  the same body (``reconstruct_window``) staging an explicit operand in
  place of a draw;
- ``qz_reconstruct_batched_bwd_plan`` (the round's backward) and
  ``qz_reconstruct_bwd_plan`` (its K=1 entry: every local backward) —
  ``plan_bwd_kernel``, on the plan's compact layout
  (``core.transpose_plan.build_plan_layout``) of either order;
- ``qz_reconstruct_batched_bwd`` (the scatter transpose, the round's
  backward under ``REPRO_BWD_PLAN=scatter``) and ``qz_reconstruct_bwd``
  (its K=1 entry: the local backward under scatter) —
  ``scatter_bwd_kernel``, which regenerates Q and reads no plan, and
  equals ``plan_bwd_kernel`` on the canonical plan bit for bit;
- ``qz_sample_pack_batched_fwd`` (the round's upload) —
  ``sample_pack_kernel``; and ``qz_sample_pack_fwd`` (its K=1 entry:
  each rank's upload in the sharded round), its draw word a scalar
  argument.

Every K=1 form is its batched kernel launched at K=1 behind its own
wrapper and launch counter.  The forward and backward kernels take a
leaf's launch constants by pointer: the forward's made once per (spec,
K, operand) from ``reconstruct_geometry``, the scatter's once per
(spec, K) from ``scatter_geometry``, the plan walk's once per (spec,
device, order),
holding the compact plan layout it reads, with ``plan_geometry``'s
client group for each K.  So the card keeps no padded plan for either
backward (``clear_caches`` drops the layouts).

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
from ..core.transpose_plan import PlanLayout, build_plan_layout
from .nvcc import (SMEM_MAX, KernelLibrary, magic_div, raise_on,
                   source_constant)

MAX_K = 1024
MAX_ROWS = 1 << 31  # row and coordinate arithmetic is uint32

# The backward kernels' geometry.  The scatter: its threads (the
# kernel's own constant), the edges a pass regenerates, the words its
# coordinates' row masks may take (so a window holds at most
# SCATTER_MASK_WORDS coordinates), the floats of a sweep's cotangents and
# partial sums, and the client-group sizes its walk is built for.  The
# plan walk: its threads, the slab entries a CTA stages at once, the most
# rows a window for which it stages cotangents, and the cotangent floats
# it stages at once.
SCATTER_THREADS = source_constant("qz_reconstruct.cu", "SCATTER_THREADS")
SCATTER_EDGES = 2048
SCATTER_MASK_WORDS = 8192
SCATTER_STAGE_FLOATS = 8192
SCATTER_GROUPS = (1, 2, 4, 8)
PLAN_THREADS = source_constant("qz_reconstruct.cu", "PLAN_THREADS")
PLAN_PIECE_MAX = 16384
PLAN_STAGE_G_MAX = 8192
PLAN_STAGE_FLOATS = 16384
# The forward's geometry: its threads (the kernel's own constant), the
# client groups it is built for, the shared-memory words a sweep stages
# (a client's window of operands, or a word of 32 clients' bits, per
# coordinate), the CTAs it slices windows into at least where the leaf
# has too few windows, and the fewest rows a slice takes.
FWD_THREADS = source_constant("qz_reconstruct.cu", "FWD_THREADS")
FWD_GROUPS = (1, 4, 8, 16, 32)
FWD_STAGE_WORDS = 16384
FWD_TARGET_CTAS = 264
FWD_ROWS_MIN = 32

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
    P, I, U, L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_longlong)
    lib.qz_sample_reconstruct.argtypes = [P, I, P, P, P, P]
    lib.qz_sample_reconstruct.restype = I
    lib.qz_reconstruct_batched.argtypes = [P, P, P, P]
    lib.qz_reconstruct_batched.restype = I
    lib.qz_plan_bwd.argtypes = [P, P, I, I, I, I, P, P]
    lib.qz_plan_bwd.restype = I
    lib.qz_sample_pack.argtypes = [P, P, I, L, U, U, P, P]
    lib.qz_sample_pack.restype = I
    lib.qz_scatter_bwd.argtypes = [P, P, P, P]
    lib.qz_scatter_bwd.restype = I
    lib.qz_sample_pack_one.argtypes = [P, U, U, U, U, P, P]
    lib.qz_sample_pack_one.restype = I


LIBRARY = KernelLibrary("qz_reconstruct.cu", ("qz_common.cuh",), _bind)


def build() -> ctypes.CDLL:
    """Compile (once per source digest) and load the kernel library."""
    return LIBRARY.load()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class FwdGeometry(NamedTuple):
    """Launch geometry of ``reconstruct_window`` at one leaf and K."""

    ctas: int  # num_windows x slices
    threads: int
    slices: int  # CTAs a window, each staging it
    rows: int  # a window's rows a CTA (the last slice may hold fewer)
    clients: int  # clients a sweep: their bits (and operands) staged
    group: int  # clients a row's thread sums, in registers (G)
    words: int  # client words a coordinate's bits take in a sweep
    sweeps: int  # of the window, each regenerating its rows
    smem: int  # dynamic shared memory of a CTA, bytes


def fwd_group(K: int) -> int:
    """The clients a row's thread of the forward sums in registers: the
    least of FWD_GROUPS that holds K, at most 32 (one client word)."""
    return next(g for g in FWD_GROUPS if g >= min(K, FWD_GROUPS[-1]))


def fwd_words(d: int, window: int, clients: int, values: bool) -> int:
    """``fwd_words(...)`` of csrc/qz_reconstruct.cu: the slots' mixed
    counters, the sweep's mask prefixes (drawn operands), its bit words
    and (explicit operands) its operands."""
    cw = -(-clients // 32)
    return (2 * d + (0 if values else clients) + cw * window
            + (clients * window if values else 0))


@functools.lru_cache(maxsize=None)
def reconstruct_geometry(window: int, rows_per_window: int, d: int,
                         num_windows: int, K: int = 1,
                         values: bool = False) -> FwdGeometry:
    """The forward's geometry: a CTA a slice of a window's rows, the
    window cut into ``slices`` where the leaf has fewer than
    FWD_TARGET_CTAS windows (no slice under FWD_ROWS_MIN rows); per sweep
    of ``clients`` clients (all K where a sweep's staging fits
    FWD_STAGE_WORDS words) the window's bits, a word of 32 clients per
    coordinate, drawn (or, with ``values``, the explicit operands staged
    and their bits where not +-0); a thread a (row, group of G clients)
    pair."""
    if not (2 <= window and window & (window - 1) == 0 and 1 <= d < window
            and rows_per_window >= 1 and num_windows >= 1
            and 1 <= K <= MAX_K):
        raise ValueError(f"the forward takes a power-of-two window >= 2, "
                         f"1 <= d < window and K <= {MAX_K}; got "
                         f"window={window}, d={d}, "
                         f"rows_per_window={rows_per_window}, K={K}")
    slices = max(1, min(-(-FWD_TARGET_CTAS // num_windows),
                        -(-rows_per_window // FWD_ROWS_MIN)))
    rows = -(-rows_per_window // slices)
    slices = -(-rows_per_window // rows)
    group = fwd_group(K)
    if values:  # a client's window of operands, and its share of a word
        clients = K
        while (clients > group and fwd_words(d, window, clients, True)
               - 2 * d > FWD_STAGE_WORDS):
            clients = (clients - 1) // group * group
    else:  # whole words of 32 clients' bits
        clients = min(K, 32 * max(1, FWD_STAGE_WORDS // window))
    smem = 4 * fwd_words(d, window, clients, values)
    if smem > SMEM_MAX:
        raise ValueError(f"the forward at window={window}, d={d}, K={K} "
                         f"needs {smem} B of shared memory a CTA")
    return FwdGeometry(num_windows * slices, FWD_THREADS, slices, rows,
                       clients, group, -(-clients // 32), -(-K // clients),
                       smem)


class ScatterGeometry(NamedTuple):
    """Launch geometry of ``scatter_bwd_kernel`` at one leaf and K."""

    ctas: int  # one a window
    threads: int
    chunk_rows: int  # a window's rows a pass: chunk_rows * d <= SCATTER_EDGES
    mask_stride: int  # words of a coordinate's row mask, odd, >= rows / 32
    passes: int  # passes of a full window
    clients: int  # clients a sweep: their cotangents (and sums) in smem
    group: int  # clients a walking thread sums, in registers (G)
    sweeps: int  # of the window, each regenerating its edges
    smem: int  # dynamic shared memory of a CTA, bytes
    div_d: Tuple[int, int, int]  # magic_div(d)


def client_group(K: int) -> int:
    """The clients a walking thread of either backward sums in registers:
    the least of SCATTER_GROUPS that holds K, at most the largest."""
    return next(g for g in SCATTER_GROUPS if g >= min(K, SCATTER_GROUPS[-1]))


def scatter_words(window: int, rows_per_window: int, mask_stride: int,
                  chunk_rows: int, d: int, clients: int, group: int) -> int:
    """``scatter_layout(...).words`` of csrc/qz_reconstruct.cu: its
    regions, each from a multiple of 4 words."""
    def up4(x):
        return -(-x // 4) * 4

    cl = -(-clients // group) * group
    multi = rows_per_window > chunk_rows
    return (up4(chunk_rows * cl) + up4(2 * chunk_rows)
            + (up4(clients * window) if multi else 0) + 2 * up4(chunk_rows)
            + up4(chunk_rows * d) + 2 * up4(d) + up4(window * mask_stride)
            + 1)


@functools.lru_cache(maxsize=None)
def scatter_geometry(window: int, rows_per_window: int, d: int,
                     num_windows: int, K: int = 1) -> ScatterGeometry:
    """The scatter's geometry: a CTA a window, regenerating its edges in
    passes of ``chunk_rows`` rows, for a sweep of ``clients`` clients at
    a time; shared memory holds the coordinates' row masks (an odd stride
    of words, so neighbouring coordinates' masks lie in different banks),
    the slots' mixed counters, the pass's rows, the sweep's cotangents of
    them and the edges' values, and where a window takes several passes
    the sweep's partial sums."""
    if not (2 <= window <= SCATTER_MASK_WORDS and window & (window - 1) == 0
            and 1 <= d <= SCATTER_EDGES and rows_per_window >= 1
            and num_windows >= 1 and 1 <= K <= MAX_K):
        raise ValueError(f"the scatter takes a power-of-two window in [2, "
                         f"{SCATTER_MASK_WORDS}], d <= {SCATTER_EDGES} and "
                         f"K <= {MAX_K}; got window={window}, d={d}, "
                         f"rows_per_window={rows_per_window}, K={K}")
    most = (SCATTER_MASK_WORDS // window
            - (SCATTER_MASK_WORDS // window + 1) % 2)  # odd
    chunk_rows = min(SCATTER_EDGES // d, rows_per_window, 32 * most)
    stride = -(-chunk_rows // 32) | 1
    group = client_group(K)
    multi = rows_per_window > chunk_rows
    per_client = chunk_rows + (window if multi else 0)
    clients = K
    if K * per_client > SCATTER_STAGE_FLOATS:
        clients = max(group, SCATTER_STAGE_FLOATS // per_client // group
                      * group)
    words = scatter_words(window, rows_per_window, stride, chunk_rows, d,
                          clients, group)
    if 4 * words > SMEM_MAX:
        raise ValueError(f"the scatter at window={window}, d={d}, K={K} "
                         f"needs {4 * words} B of shared memory a CTA")
    return ScatterGeometry(num_windows, SCATTER_THREADS, chunk_rows, stride,
                           -(-rows_per_window // chunk_rows), clients, group,
                           -(-K // clients), 4 * words, magic_div(d))


class PlanGeometry(NamedTuple):
    """Launch geometry of ``plan_bwd_kernel`` at one leaf and K."""

    ctas: int  # one a window
    threads: int
    piece: int  # slab entries staged at once
    passes: int  # pieces of the largest window's slab
    stage_g: bool  # the window's cotangents staged in shared memory
    stage: int  # clients staged at once (K where none are)
    stages: int  # staged client groups a piece
    group: int  # clients a walking thread sums, in registers (G)
    smem: int  # dynamic shared memory of a CTA, bytes
    row_bytes: int  # of a layout entry's row: 2 (narrow) or 4


@functools.lru_cache(maxsize=None)
def plan_geometry(rows_per_window: int, num_windows: int, max_slab: int,
                  narrow: bool, K: int = 1) -> PlanGeometry:
    """The plan walk's geometry: a CTA a window, its slab staged a piece
    of at most ``PLAN_PIECE_MAX`` entries at a time (6 bytes an entry
    with narrow rows, else 8), once for all K clients; beside it, where a
    client's fit, the window's cotangents of ``stage`` clients at a time,
    each client's rows at an odd stride; a thread a (coordinate, group of
    G clients) pair."""
    if not 1 <= K <= MAX_K:
        raise ValueError(f"{K} clients outside [1, {MAX_K}]")
    piece = max(1, min(max_slab, PLAN_PIECE_MAX))
    stage_g = rows_per_window <= PLAN_STAGE_G_MAX
    row_bytes = 2 if narrow else 4
    g_stride = rows_per_window | 1
    group = client_group(K)
    stage = min(K, PLAN_STAGE_FLOATS // g_stride) if stage_g else K
    if group <= stage < K:  # whole walking groups a stage
        stage = stage // group * group
    smem = (piece * (4 + row_bytes) + 4
            + (4 * stage * g_stride if stage_g else 0))
    return PlanGeometry(num_windows, PLAN_THREADS, piece,
                        max(1, -(-max_slab // piece)), stage_g, stage,
                        -(-K // stage), group, smem, row_bytes)


class _ScatterConsts(ctypes.Structure):
    """ScatterConsts of csrc/qz_reconstruct.cu."""

    _fields_ = [("seed", ctypes.c_uint), ("tensor_id", ctypes.c_uint),
                ("window", ctypes.c_int), ("rows_per_window", ctypes.c_uint),
                ("d", ctypes.c_int), ("sigma", ctypes.c_float)] + [
        (name, ctypes.c_uint) for name in (
            "m", "n", "num_windows", "K", "clients", "group", "chunk_rows",
            "mask_stride", "div_m", "div_s1", "div_s2")] + [
        ("smem", ctypes.c_int)]


class _FwdConsts(ctypes.Structure):
    """FwdConsts of csrc/qz_reconstruct.cu."""

    _fields_ = [("seed", ctypes.c_uint), ("tensor_id", ctypes.c_uint),
                ("window", ctypes.c_int), ("rows_per_window", ctypes.c_uint),
                ("d", ctypes.c_int), ("sigma", ctypes.c_float)] + [
        (name, ctypes.c_uint) for name in (
            "m", "n", "num_windows", "K", "slices", "rows", "clients",
            "group")] + [("values", ctypes.c_int), ("smem", ctypes.c_int)]


class _PlanConsts(ctypes.Structure):
    """PlanConsts of csrc/qz_reconstruct.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "rows", "vals", "starts")] + [(name, ctypes.c_uint) for name in (
            "m", "n", "window", "rows_per_window", "num_windows")] + [
        (name, ctypes.c_int) for name in ("piece", "narrow", "stage_g")]


def fwd_geometry(spec: QSpec, K: int = 1,
                 values: bool = False) -> FwdGeometry:
    """The forward's geometry at a leaf for K clients (``values``: an
    explicit operand, kernels 3 and 1; else drawn, kernels 8 and 7)."""
    return reconstruct_geometry(spec.window, spec.rows_per_window, spec.d,
                                spec.num_windows, K, values)


@functools.lru_cache(maxsize=64)
def _fwd_consts(spec: QSpec, K: int, values: bool) -> tuple:
    """The forward's launch constants at a leaf for K clients: (struct,
    its address)."""
    _check_spec(spec)
    geo = fwd_geometry(spec, K, values)
    c = _FwdConsts(spec.seed & 0xFFFFFFFF, spec.tensor_id, spec.window,
                   spec.rows_per_window, spec.d, sigma_f32(spec), spec.m,
                   spec.n, spec.num_windows, K, geo.slices, geo.rows,
                   geo.clients, geo.group, int(values), geo.smem)
    return c, ctypes.addressof(c)


def scatter_bwd_geometry(spec: QSpec, K: int = 1) -> ScatterGeometry:
    """The scatter's geometry at a leaf for K clients."""
    return scatter_geometry(spec.window, spec.rows_per_window, spec.d,
                            spec.num_windows, K)


@functools.lru_cache(maxsize=64)
def _scatter_consts(spec: QSpec, K: int) -> tuple:
    """The scatter's launch constants at a leaf for K clients: (struct,
    its address)."""
    _check_spec(spec)
    geo = scatter_bwd_geometry(spec, K)
    c = _ScatterConsts(spec.seed & 0xFFFFFFFF, spec.tensor_id, spec.window,
                       spec.rows_per_window, spec.d, sigma_f32(spec), spec.m,
                       spec.n, spec.num_windows, K, geo.clients, geo.group,
                       geo.chunk_rows, geo.mask_stride, *geo.div_d, geo.smem)
    return c, ctypes.addressof(c)


class _PlanEntry(NamedTuple):
    """The plan walk's launch constants at a leaf on one card, holding the
    compact plan layout that ``consts`` points into."""

    layout: PlanLayout
    consts: _PlanConsts
    address: int


_PLAN_ENTRIES: Dict[tuple, _PlanEntry] = {}  # by (spec, device, order)
_PLAN_ENTRIES_MAX = 64


def _plan_entry(spec: QSpec, device: int, order: str) -> _PlanEntry:
    key = (spec, device, order)
    entry = _PLAN_ENTRIES.get(key)
    if entry is not None:
        return entry
    _check_spec(spec)
    layout = build_plan_layout(spec, torch.device("cuda", device), order)
    geo = plan_geometry(spec.rows_per_window, spec.num_windows,
                        layout.max_slab, layout.narrow)
    c = _PlanConsts(layout.rows.data_ptr(), layout.vals.data_ptr(),
                    layout.starts.data_ptr(), spec.m, spec.n, spec.window,
                    spec.rows_per_window, spec.num_windows, geo.piece,
                    int(layout.narrow), int(geo.stage_g))
    if len(_PLAN_ENTRIES) >= _PLAN_ENTRIES_MAX:  # the oldest goes
        del _PLAN_ENTRIES[next(iter(_PLAN_ENTRIES))]
    entry = _PLAN_ENTRIES[key] = _PlanEntry(layout, c, ctypes.addressof(c))
    return entry


def _device_index(device) -> int:
    dev = torch.device(device)
    return torch.cuda.current_device() if dev.index is None else dev.index


def plan_layout(spec: QSpec, device, order: str = "canonical") -> PlanLayout:
    """The compact plan layout the plan walk reads at a leaf on a card
    (built there at first use, and held for later launches)."""
    return _plan_entry(spec, _device_index(device), order).layout


def plan_bwd_geometry(spec: QSpec, device, order: str = "canonical",
                      K: int = 1) -> PlanGeometry:
    """The plan walk's geometry at a leaf on a card for K clients (builds
    its layout there)."""
    lay = plan_layout(spec, device, order)
    return plan_geometry(spec.rows_per_window, spec.num_windows,
                         lay.max_slab, lay.narrow, K)


def plan_state_bytes() -> int:
    """Bytes of the compact plan layouts held for the plan walk."""
    return sum(t.numel() * t.element_size()
               for e in _PLAN_ENTRIES.values() for t in (
                   e.layout.rows, e.layout.vals, e.layout.starts))


def clear_caches() -> None:
    """Drop the kernels' launch constants, and with them the compact plan
    layouts the plan walk reads."""
    _fwd_consts.cache_clear()
    _scatter_consts.cache_clear()
    _PLAN_ENTRIES.clear()


def _check_one_cotangent(spec: QSpec, g: torch.Tensor) -> None:
    """A one-client backward reads m floats from g's pointer."""
    if (g.dtype != torch.float32 or g.shape != (spec.m,)
            or not g.is_contiguous()):
        raise ValueError(f"g must be contiguous ({spec.m},) float32, got "
                         f"{tuple(g.shape)} {g.dtype}")


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
    address = _fwd_consts(spec, K, False)[1]
    W = torch.empty((K, spec.m), dtype=torch.float32, device=P.device)
    rc = build().qz_sample_reconstruct(
        P.data_ptr(), _KIND[qbits], words.data_ptr(), W.data_ptr(), address,
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
    address = _fwd_consts(spec, K, True)[1]
    W = torch.empty((K, spec.m), dtype=torch.float32, device=Z.device)
    rc = build().qz_reconstruct_batched(Z.data_ptr(), W.data_ptr(), address,
                                        _stream(Z))
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


def _launch_plan_bwd(spec: QSpec, G: torch.Tensor, K: int, out_shape,
                     order: str) -> torch.Tensor:
    """``plan_bwd_kernel`` on K contiguous (m,) f32 cotangents at G's
    pointer, into a new tensor of ``out_shape`` (K * n floats)."""
    dev = G.get_device()
    entry = _plan_entry(spec, dev, order)
    geo = plan_geometry(spec.rows_per_window, spec.num_windows,
                        entry.layout.max_slab, entry.layout.narrow, K)
    out = G.new_empty(out_shape)
    raise_on(build().qz_plan_bwd(
        G.data_ptr(), out.data_ptr(), K, geo.stage, geo.group, geo.smem,
        entry.address, torch._C._cuda_getCurrentRawStream(dev)),
        "qz_plan_bwd")
    return out


def _launch_scatter_bwd(spec: QSpec, G: torch.Tensor, K: int,
                        out_shape) -> torch.Tensor:
    """``scatter_bwd_kernel`` on K contiguous (m,) f32 cotangents at G's
    pointer, into a new tensor of ``out_shape`` (K * n floats)."""
    address = _scatter_consts(spec, K)[1]
    out = G.new_empty(out_shape)
    raise_on(build().qz_scatter_bwd(
        G.data_ptr(), out.data_ptr(), address,
        torch._C._cuda_getCurrentRawStream(G.get_device())),
        "qz_scatter_bwd")
    return out


def qz_reconstruct_batched_bwd_plan(spec: QSpec, G: torch.Tensor,
                                    order: str = "canonical"):
    """grad_Z (K, n) = Q^T G_k over the ``order`` transpose plan; ``G``
    (K, m) f32 cotangents in moved flat order."""
    if not G.is_cuda:
        from .ops import plan_bwd_plain

        return plan_bwd_plain(spec, G, order)
    G = _check_cotangent(spec, G)
    K = G.shape[0]
    out = _launch_plan_bwd(spec, G, K, (K, spec.n), order)
    LAUNCHES["qz_reconstruct_batched_bwd_plan"] += 1
    return out


def qz_reconstruct_bwd_plan(spec: QSpec, g: torch.Tensor,
                            order: str = "canonical"):
    """grad_z (n,) = Q^T g over the ``order`` transpose plan for one
    cotangent g (m,) f32 in moved flat order: the batched kernel at K=1,
    so it equals a row of ``qz_reconstruct_batched_bwd_plan`` bit for
    bit."""
    if not g.is_cuda:
        from .ops import plan_bwd_one_plain

        return plan_bwd_one_plain(spec, g, order)
    _check_one_cotangent(spec, g)
    out = _launch_plan_bwd(spec, g, 1, (spec.n,), order)
    LAUNCHES["qz_reconstruct_bwd_plan"] += 1
    return out


def qz_reconstruct_batched_bwd(spec: QSpec, G: torch.Tensor):
    """grad_Z (K, n) = Q^T G_k by the scatter, Q regenerated in the
    kernel and no plan held; ``G`` (K, m) f32 cotangents in moved flat
    order.  Equals ``qz_reconstruct_batched_bwd_plan`` on the canonical
    plan bit for bit."""
    if not G.is_cuda:
        from .ops import scatter_bwd_plain

        return scatter_bwd_plain(spec, G)
    G = _check_cotangent(spec, G)
    K = G.shape[0]
    out = _launch_scatter_bwd(spec, G, K, (K, spec.n))
    LAUNCHES["qz_reconstruct_batched_bwd"] += 1
    return out


def qz_reconstruct_bwd(spec: QSpec, g: torch.Tensor):
    """grad_z (n,) = Q^T g by the scatter for one cotangent g (m,) f32
    in moved flat order: the batched kernel at K=1, so it equals a row of
    ``qz_reconstruct_batched_bwd`` bit for bit."""
    if not g.is_cuda:
        from .ops import scatter_bwd_one_plain

        return scatter_bwd_one_plain(spec, g)
    _check_one_cotangent(spec, g)
    out = _launch_scatter_bwd(spec, g, 1, (spec.n,))
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
