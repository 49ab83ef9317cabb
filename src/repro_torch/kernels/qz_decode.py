"""Streamed serve matmul/matvec as a CUDA kernel for Hopper (sm_90a).

Replaces the Pallas kernels ``qz_sample_matmul`` and ``qz_sample_matvec``
of the JAX package's ``kernels/qz_decode.py``.  The source is
``csrc/qz_decode.cu`` with its device functions in ``csrc/qz_common.cuh``
(design and summation order are described there).  It is compiled with
``nvcc`` at first use into ``build/repro_torch/`` of the checkout, as a
shared library with a plain C interface, and bound with ``ctypes``.

The wrappers take CUDA tensors and launch the kernel, or raise; given a
CPU tensor they run the plain torch version
(``kernels.ops.serve_contract_plain``).  Each wrapper counts its
launches in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ..core.qspec import QSpec, sigma_f32
from ..core.sampling import as_word
from .nvcc import KernelLibrary, raise_on
from .ops import SERVE_BM, serve_contract_plain

MAX_BATCH = 128  # keeps the CTA's shared memory under 48 KB
MAX_ROWS = 1 << 31  # the kernel's row arithmetic is uint32

LAUNCHES: Dict[str, int] = {"qz_sample_matmul": 0, "qz_sample_matvec": 0}

_KIND = {None: 0, 8: 1, 16: 2}
_DTYPE = {None: torch.float32, 8: torch.uint8, 16: torch.uint16}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    P, I, U, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_float)
    lib.qz_serve_matmul.argtypes = [P, I, I, U, P, P, I, U, U, I, U, I, F,
                                    U, I, I, I, P]
    lib.qz_serve_matmul.restype = I
    lib.qz_edges.argtypes = [P, I, I, U, P, I, U, U, I, U, I, F, P, P, P,
                             P, P]
    lib.qz_edges.restype = I


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
    lib = build()
    X = X.contiguous()
    Y = torch.empty((B, d_out), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = lib.qz_serve_matmul(
        p.data_ptr(), _KIND[qbits], qbits or 0, as_word(step), X.data_ptr(),
        Y.data_ptr(), B, spec.seed & 0xFFFFFFFF, spec.tensor_id,
        spec.window, spec.rows_per_window, spec.d, sigma_f32(spec),
        row_offset, d_in, d_out, bm, stream)
    raise_on(rc, "qz_serve_matmul")
    return Y


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
            p.data_ptr(), _KIND[qbits], qbits or 0, as_word(step),
            rows.data_ptr(), R, spec.seed & 0xFFFFFFFF, spec.tensor_id,
            spec.window, spec.rows_per_window, spec.d, sigma_f32(spec),
            idx.data_ptr(), bits.data_ptr(), vals.data_ptr(), w.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        raise_on(rc, "qz_edges")
    return idx, bits, vals, w

