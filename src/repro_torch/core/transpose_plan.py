"""Per-spec caches of Q's generation plans: the rows, and the transpose.

The JAX package's ``core/transpose_plan.py``, canonical order only.

``row_plan(spec, device)`` is the forward row plan: ``(gidx (m_pad, d)
global z coordinates, vals (m_pad, d) f32)`` for every padded row,
generated once per (spec, device) by the port's ``row_indices`` /
``row_values`` ON THAT DEVICE.  On the card that matters: the kernels
regenerate Q's values in their bodies with CUDA's ``logf``/``cosf``,
which give torch's CUDA bits, so a plan built on the card holds exactly
the kernels' Q, while one built on the CPU would differ by ulps.

``build_transpose_plan(spec, device)`` inverts the row plan into
per-coordinate incoming-edge lists (``transpose_plan.py:15-52`` of the
JAX package):

    rows (num_windows, window, deg) int32   window-local source rows
    vals (num_windows, window, deg) f32     0.0 on padding entries

with ``deg`` the exact maximum in-degree.  Canonical order: each
coordinate's edges sorted by (source row, slot k).  Padding entries
point at row 0 with value 0; edges of padding rows are left out.  The
counting sort runs on the host (numpy, on the index stream only); the
values are placed by a pure gather on the device, so their bits are
the device's.

``REPRO_BWD_PLAN`` keeps its name and spelling; the port has the
canonical plan only, so ``plan:slot`` and ``scatter`` raise.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from .qspec import (QSpec, padded_row_valid, padded_row_window, row_indices,
                    row_values)

_VALID_BWD_PATHS = ("plan", "plan:canonical", "plan:slot", "scatter")
_LATER_BWD_PATHS = ("plan:slot", "scatter")


def resolve_bwd_path(path: str | None = None) -> str:
    """The plan order of a backward path (the argument, else
    ``REPRO_BWD_PLAN``, else ``plan``).  Only the canonical plan is
    ported; the slot order and the scatter transpose raise."""
    path = path or os.environ.get("REPRO_BWD_PLAN") or "plan"
    if path not in _VALID_BWD_PATHS:
        raise ValueError(f"unknown bwd path {path!r}; valid paths: "
                         f"{', '.join(_VALID_BWD_PATHS)}")
    if path in _LATER_BWD_PATHS:
        raise NotImplementedError(
            f"bwd path {path!r}: the port has the canonical transpose plan "
            "only; the slot order and the scatter transpose (kernels "
            "qz_reconstruct_bwd / _batched_bwd) come with a later slice")
    return "canonical"


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def row_plan(spec: QSpec, device="cpu"):
    """``(gidx (m_pad, d) int64 global z coordinates, vals (m_pad, d)
    f32)`` of every padded row, built once per (spec, device)."""
    return _row_plan(spec, _device(device))


@functools.lru_cache(maxsize=32)
def _row_plan(spec: QSpec, device: torch.device):
    rp = torch.arange(spec.m_pad, dtype=torch.int64, device=device)
    gidx = (padded_row_window(spec, rp)[:, None] * spec.window
            + row_indices(spec, rp))
    return gidx, row_values(spec, rp)


@dataclass(frozen=True, eq=False)
class TransposePlan:
    """Inverted row plan on one device: ``rows[w, c, e]`` is the
    window-local source row of edge ``e`` into coordinate
    ``w*window + c`` and ``vals[w, c, e]`` its Q value (0 on padding
    entries, which point at row 0); ``counts`` the exact in-degree
    (n,); ``deg`` its maximum (>= 1).  Window ``w``'s rows start at
    padded row ``w * rows_per_window``."""

    deg: int
    rows: torch.Tensor  # (num_windows, window, deg) int32
    vals: torch.Tensor  # (num_windows, window, deg) f32
    counts: torch.Tensor  # (n,) int64

    @property
    def n_edges(self) -> int:
        return int(self.counts.sum())


def build_transpose_plan(spec: QSpec, device="cpu") -> TransposePlan:
    """Invert the row plan into per-coordinate incoming-edge lists, in
    canonical order."""
    return _build_transpose_plan(spec, _device(device))


@functools.lru_cache(maxsize=32)
def _build_transpose_plan(spec: QSpec, device: torch.device):
    gidx, vals = row_plan(spec, device)
    d = spec.d
    rp = np.arange(spec.m_pad, dtype=np.int64)
    valid = np.repeat(padded_row_valid(spec, torch.from_numpy(rp)).numpy(), d)
    # canonical: the row-major (row, k) enumeration, stably sorted by
    # coordinate, keeps each coordinate's edges in (row, k) order
    coord = gidx.cpu().numpy().reshape(-1)[valid]
    src = np.arange(spec.m_pad * d, dtype=np.int64)[valid]
    r_local = np.repeat(rp % spec.rows_per_window, d)[valid]
    perm = np.argsort(coord, kind="stable")
    ks, rs, src = coord[perm], r_local[perm], src[perm]
    counts = np.bincount(ks, minlength=spec.n).astype(np.int64)
    deg = int(max(1, counts.max() if counts.size else 1))
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = ks * deg + (np.arange(ks.size, dtype=np.int64) - starts[ks])
    rows = np.zeros(spec.n * deg, np.int32)
    rows[slot] = rs
    flat_vals = torch.zeros(spec.n * deg, dtype=torch.float32, device=device)
    flat_vals[torch.from_numpy(slot).to(device)] = vals.reshape(-1)[
        torch.from_numpy(src).to(device)]
    shape = (spec.num_windows, spec.window, deg)
    return TransposePlan(
        deg=deg,
        rows=torch.from_numpy(rows).to(device).reshape(shape),
        vals=flat_vals.reshape(shape),
        counts=torch.from_numpy(counts).to(device))
