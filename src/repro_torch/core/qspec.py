"""QSpec: the static description of one tensor's influence matrix Q.

Q (m x n) has ``d`` non-zeros per row.  Row ``i`` draws its indices
from the contiguous window ``i // rows_per_window`` of z (``window`` a
power of two), as

    idx_k = (base + k * stride) mod window,   stride odd,

so the d indices are distinct.  Values are N(0, 6 / (d * fan_in)) by
Box-Muller.  ``make_qspec`` is pure Python and gives the same fields as
the JAX package's ``core/qspec.py``; ``row_indices``/``row_values``
regenerate the same streams.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .hashrng import H0, fmix32, gaussian_from_u32, hash_fold

# Counter-space roles for hash_u32(seed, tensor_id, row, ctr).
CTR_BASE = 0x0001_0000
CTR_STRIDE = 0x0002_0000
CTR_VAL = 0x0004_0000  # value k uses counters CTR_VAL + 2k, +2k+1


@dataclass(frozen=True)
class QSpec:
    """Static (hashable) spec of one tensor's sparse influence matrix."""

    tensor_id: int
    shape: tuple  # original weight tensor shape
    m: int  # number of weights = prod(shape)
    n: int  # trainable-parameter count (num_windows * window)
    n_raw: int  # ceil(m / compression) before window padding
    d: int  # non-zeros per row
    window: int  # z-window size (power of two)
    num_windows: int
    rows_per_window: int
    m_pad: int
    fan_in: int
    seed: int
    major_axis: int = 0
    shard_count: int = 1

    @property
    def sigma(self) -> float:
        return math.sqrt(6.0 / (self.d * max(self.fan_in, 1)))

    @property
    def compression(self) -> float:
        return self.m / self.n

    # --- layout: rows grouped into shard_count contiguous blocks, the
    # tensor flattened with major_axis moved to the front
    @property
    def m_blk(self) -> int:
        return self.m // self.shard_count

    @property
    def nw_loc(self) -> int:
        return self.num_windows // self.shard_count

    @property
    def m_pad_loc(self) -> int:
        return self.nw_loc * self.rows_per_window

    @property
    def moved_shape(self) -> tuple:
        a = self.major_axis
        return (self.shape[a], *self.shape[:a], *self.shape[a + 1:])


def make_qspec(tensor_id: int, shape, fan_in: int, *,
               compression: float = 32.0, d: int = 8, window: int = 512,
               seed: int = 0, align: int = 1, major_axis: int = 0,
               shard_count: int = 1) -> QSpec:
    """Build a QSpec for a weight tensor (the JAX package's rules)."""
    shape = tuple(int(s) for s in shape)
    m = int(math.prod(shape))
    major_axis = int(major_axis)
    shard_count = int(shard_count)
    if shard_count > 1 and (shape[major_axis] % shard_count
                            or m % shard_count):
        major_axis, shard_count = 0, 1
    n_raw = max(1, math.ceil(m / compression))
    window = int(min(window, 1 << max(1, math.ceil(math.log2(max(n_raw, 2))))))
    if window & (window - 1):
        raise ValueError(f"window must be a power of two, got {window}")
    if d >= window:
        d = max(1, window // 2)
    align = max(align, shard_count)
    num_windows = max(1, math.ceil(n_raw / window))
    num_windows = math.ceil(num_windows / align) * align
    n = num_windows * window
    nw_loc = num_windows // shard_count
    m_blk = m // shard_count
    rows_per_window = math.ceil(m_blk / nw_loc)
    m_pad = rows_per_window * nw_loc * shard_count
    return QSpec(tensor_id=int(tensor_id), shape=shape, m=m, n=n,
                 n_raw=n_raw, d=int(d), window=window,
                 num_windows=num_windows, rows_per_window=rows_per_window,
                 m_pad=m_pad, fan_in=int(fan_in), seed=int(seed),
                 major_axis=major_axis, shard_count=shard_count)


def padded_row_window(spec: QSpec, rp: torch.Tensor) -> torch.Tensor:
    """Padded row id -> global window id (shard-block aware), int64."""
    blk = rp // spec.m_pad_loc
    loc = rp % spec.m_pad_loc
    return blk * spec.nw_loc + torch.clamp(loc // spec.rows_per_window,
                                           max=spec.nw_loc - 1)


def padded_row_valid(spec: QSpec, rp: torch.Tensor) -> torch.Tensor:
    """True where a padded row id maps to a real weight."""
    return (rp % spec.m_pad_loc) < spec.m_blk


def row_state(spec: QSpec, rows: torch.Tensor) -> torch.Tensor:
    """Hash state after (seed, tensor_id, row): every Q stream of a row
    continues from it."""
    return hash_fold(H0, spec.seed, spec.tensor_id, rows.to(torch.int64))


def row_indices(spec: QSpec, rows: torch.Tensor) -> torch.Tensor:
    """In-window column indices (int64, ``(..., d)``) of the given rows.

    The global z index is ``(rows // rows_per_window) * window + idx``.
    """
    hr = row_state(spec, rows)
    base = fmix32(hash_fold(hr, CTR_BASE)) & (spec.window - 1)
    stride = (fmix32(hash_fold(hr, CTR_STRIDE)) % (spec.window // 2)) * 2 + 1
    k = torch.arange(spec.d, dtype=torch.int64, device=rows.device)
    return (base[..., None] + stride[..., None] * k) & (spec.window - 1)


def row_values(spec: QSpec, rows: torch.Tensor) -> torch.Tensor:
    """Gaussian coefficients ``q_{i,k}`` (float32, ``(..., d)``)."""
    hr = row_state(spec, rows)[..., None]
    k = torch.arange(spec.d, dtype=torch.int64, device=rows.device)
    ua = fmix32(hash_fold(hr, CTR_VAL + 2 * k))
    ub = fmix32(hash_fold(hr, CTR_VAL + 2 * k + 1))
    return gaussian_from_u32(ua, ub) * sigma_f32(spec)


def sigma_f32(spec: QSpec) -> float:
    """sigma rounded to float32, as every consumer multiplies by it."""
    return float(np.float32(spec.sigma))
