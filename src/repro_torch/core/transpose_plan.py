"""Per-spec caches of Q's generation plans, and the backward-path gate.

The JAX package's ``core/transpose_plan.py``.

``row_plan(spec, device)`` is the forward row plan: ``(gidx (m_pad, d)
global z coordinates, vals (m_pad, d) f32)`` for every padded row,
generated once per (spec, device) by the port's ``row_indices`` /
``row_values`` ON THAT DEVICE.  On the card that matters: the kernels
regenerate Q's values in their bodies with CUDA's ``logf``/``cosf``,
which give torch's CUDA bits, so a plan built on the card holds exactly
the kernels' Q, while one built on the CPU would differ by ulps.

``build_transpose_plan(spec, device, order)`` inverts the row plan into
per-coordinate incoming-edge lists (``transpose_plan.py:15-52`` of the
JAX package):

    rows (num_windows, window, deg) int32   window-local source rows
    vals (num_windows, window, deg) f32     0.0 on padding entries

with ``deg`` the exact maximum in-degree.  ``order`` fixes the edge
order inside each coordinate's list, and so the order of its sum:
``canonical`` sorts by (source row, slot k), ``slot`` by (slot k,
source row).  Padding entries point at row 0 with value 0; edges of
padding rows are left out.  The counting sort runs on the host (numpy,
on the index stream only); the values are placed by a pure gather on
the device, so their bits are the device's.

``build_plan_layout(spec, device, order)`` is the same plan without its
padding, the one format the plan kernel reads at every K: the ``m*d``
real entries in the plan's order, coordinate ``c``'s at ``[starts[c],
starts[c+1])``, so a window's entries are one contiguous slab.  It comes
from the same host sort, so the card holds neither the padded plan nor
the row plan for a backward through the kernels; the padded plan serves
the plain versions and the tests.

Each builder takes ``windows``, a range ``(w0, w1)`` of the spec's
windows (all of them by default): the plan of those windows alone, its
coordinates counted from ``w0 * window`` and its rows from
``w0 * rows_per_window``.  Window w's coordinates receive edges from
window w's rows only, so a range's plan is the same lists as the whole
plan's, and a model rank builds only its shard's
(``kernels.qz_sharded``).

The gate: ``REPRO_BWD_PLAN`` overrides the process default
(``set_default_bwd_path``, ``plan``), and ``resolve_bwd_path`` turns a
path into ``(kind, order)``: ``("plan", "canonical" | "slot")``, or
``("scatter", None)`` for the scatter transpose, which regenerates Q
and holds no plan.  The backward reads the gate each time it runs, as
the JAX package reads it at trace time.  The spellings and the error
messages are the JAX package's.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from .qspec import (QSpec, padded_row_valid, padded_row_window, row_indices,
                    row_values)

ORDERS = ("canonical", "slot")
# accepted spellings of the gate; "plan" is canonical-order
_VALID_BWD_PATHS = ("plan", "plan:canonical", "plan:slot", "scatter")
_DEFAULT_BWD_PATH = "plan"


def set_default_bwd_path(path: str) -> None:
    """Set the process-wide default transpose path (plan | scatter)."""
    global _DEFAULT_BWD_PATH
    if path not in _VALID_BWD_PATHS:
        raise ValueError(f"unknown bwd path {path!r}; valid paths: "
                         f"{', '.join(_VALID_BWD_PATHS)}")
    _DEFAULT_BWD_PATH = path


def default_bwd_path() -> str:
    """The effective transpose path: ``REPRO_BWD_PLAN`` overrides the
    ``set_default_bwd_path`` process default."""
    env = os.environ.get("REPRO_BWD_PLAN")
    if env is None:
        return _DEFAULT_BWD_PATH
    if env not in _VALID_BWD_PATHS:
        raise ValueError(f"REPRO_BWD_PLAN={env!r} is not a valid bwd path; "
                         f"valid: {', '.join(_VALID_BWD_PATHS)}")
    return env


def resolve_bwd_path(path: str | None = None):
    """``(kind, order)`` for a path string (default: the gated one):
    kind ``plan`` or ``scatter``, order the plan's edge order
    (``canonical`` | ``slot``, None for scatter)."""
    path = path or default_bwd_path()
    if path not in _VALID_BWD_PATHS:
        raise ValueError(f"unknown bwd path {path!r}; valid paths: "
                         f"{', '.join(_VALID_BWD_PATHS)}")
    if path == "scatter":
        return "scatter", None
    _, _, order = path.partition(":")
    return "plan", order or "canonical"


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def plan_windows(spec: QSpec, windows=None) -> tuple:
    """``windows`` as (w0, w1), every window by default."""
    if windows is None:
        return 0, spec.num_windows
    w0, w1 = (int(w) for w in windows)
    if not 0 <= w0 < w1 <= spec.num_windows:
        raise ValueError(f"windows ({w0}, {w1}) outside [0, "
                         f"{spec.num_windows}]")
    return w0, w1


def row_plan(spec: QSpec, device="cpu", windows=None):
    """``(gidx (rows, d) int64 z coordinates, vals (rows, d) f32)`` of
    every padded row of ``windows`` (all by default, their coordinates
    counted from the range's first), built once per (spec, device,
    range)."""
    return _row_plan(spec, _device(device), plan_windows(spec, windows))


@functools.lru_cache(maxsize=32)
def _row_plan(spec: QSpec, device: torch.device, windows: tuple):
    w0, w1 = windows
    rpw = spec.rows_per_window
    rp = torch.arange(w0 * rpw, w1 * rpw, dtype=torch.int64, device=device)
    gidx = ((padded_row_window(spec, rp)[:, None] - w0) * spec.window
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

    order: str
    deg: int
    rows: torch.Tensor  # (windows, window, deg) int32
    vals: torch.Tensor  # (windows, window, deg) f32
    counts: torch.Tensor  # (windows * window,) int64

    @property
    def n_edges(self) -> int:
        return int(self.counts.sum())


def build_transpose_plan(spec: QSpec, device="cpu",
                         order: str = "canonical",
                         windows=None) -> TransposePlan:
    """Invert the row plan of ``windows`` (all by default) into
    per-coordinate incoming-edge lists, in ``order``."""
    if order not in ORDERS:
        raise ValueError(f"unknown plan order {order!r}; valid: {ORDERS}")
    return _build_transpose_plan(spec, _device(device), order,
                                 plan_windows(spec, windows))


def _plan_entries(spec: QSpec, gidx: torch.Tensor, order: str,
                  windows: tuple):
    """The plan's real entries in ``order``, by a counting sort on the
    host of the row plan's coordinates ``gidx`` (of the range
    ``windows``): ``(coord, r_local, src, counts)``, per entry its
    coordinate (ascending), window-local source row and index into the
    flat row plan, and the in-degree of the range's coordinates."""
    d = spec.d
    w0, w1 = windows
    rpw = spec.rows_per_window
    rp = np.arange(w0 * rpw, w1 * rpw, dtype=np.int64)
    rows = rp.size
    valid = padded_row_valid(spec, torch.from_numpy(rp)).numpy()
    coord = gidx.cpu().numpy()  # (rows, d)
    src = np.arange(rows * d, dtype=np.int64).reshape(rows, d)
    r_local = np.broadcast_to((rp % spec.rows_per_window)[:, None],
                              coord.shape)
    valid = np.broadcast_to(valid[:, None], coord.shape)
    if order == "slot":  # the k-major enumeration: (k, row) per coordinate
        coord, src, r_local, valid = coord.T, src.T, r_local.T, valid.T
    # canonical: the row-major (row, k) enumeration; a stable sort by
    # coordinate keeps each coordinate's edges in enumeration order
    valid = valid.reshape(-1)
    coord = coord.reshape(-1)[valid]
    src = src.reshape(-1)[valid]
    r_local = r_local.reshape(-1)[valid]
    perm = np.argsort(coord, kind="stable")
    counts = np.bincount(coord, minlength=(w1 - w0) * spec.window).astype(
        np.int64)
    return coord[perm], r_local[perm], src[perm], counts


@functools.lru_cache(maxsize=32)
def _build_transpose_plan(spec: QSpec, device: torch.device, order: str,
                          windows: tuple):
    gidx, vals = row_plan(spec, device, windows)
    ks, rs, src, counts = _plan_entries(spec, gidx, order, windows)
    n = counts.size
    deg = int(max(1, counts.max() if counts.size else 1))
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = ks * deg + (np.arange(ks.size, dtype=np.int64) - starts[ks])
    rows = np.zeros(n * deg, np.int32)
    rows[slot] = rs
    flat_vals = torch.zeros(n * deg, dtype=torch.float32, device=device)
    flat_vals[torch.from_numpy(slot).to(device)] = vals.reshape(-1)[
        torch.from_numpy(src).to(device)]
    shape = (windows[1] - windows[0], spec.window, deg)
    return TransposePlan(
        order=order, deg=deg,
        rows=torch.from_numpy(rows).to(device).reshape(shape),
        vals=flat_vals.reshape(shape),
        counts=torch.from_numpy(counts).to(device))


@dataclass(frozen=True, eq=False)
class PlanLayout:
    """A transpose plan's real entries, in its order: coordinate ``c``'s
    (counted from its range's first) entries are ``[starts[c],
    starts[c+1])`` of ``rows`` (window-local source rows; ``narrow``:
    uint16 bits in an int16 tensor, else int32) and ``vals`` (f32).
    ``max_slab`` is the most entries of one window."""

    order: str
    rows: torch.Tensor  # (E,) int16 (uint16 bits) or int32
    vals: torch.Tensor  # (E,) f32
    starts: torch.Tensor  # (range coordinates + 1,) int32
    narrow: bool
    max_slab: int

    def local_rows(self) -> np.ndarray:
        """The rows as int64 on the host."""
        rows = self.rows.cpu().numpy()
        return (rows.view(np.uint16) if self.narrow else rows).astype(np.int64)


def build_plan_layout(spec: QSpec, device="cpu", order: str = "canonical",
                      windows=None) -> PlanLayout:
    """The ``order`` transpose plan's compact layout of ``windows`` (all
    by default), from the same counting sort as the padded plan, which
    it neither builds nor reads; the row plan it sorts is made for it
    and dropped.  Not cached here: the plan kernel's launch constants
    hold it."""
    if order not in ORDERS:
        raise ValueError(f"unknown plan order {order!r}; valid: {ORDERS}")
    device = _device(device)
    windows = plan_windows(spec, windows)
    gidx, vals = _row_plan.__wrapped__(spec, device, windows)
    _, rows, src, counts = _plan_entries(spec, gidx, order, windows)
    starts = np.concatenate(([0], np.cumsum(counts)))
    if starts[-1] >= 1 << 31:
        raise ValueError(f"{starts[-1]} plan entries; the layout takes "
                         "fewer than 2^31")
    narrow = spec.rows_per_window <= 1 << 16
    rows = rows.astype(np.uint16).view(np.int16) if narrow else rows.astype(
        np.int32)
    slabs = starts[spec.window::spec.window] - starts[:-1:spec.window]
    return PlanLayout(
        order=order, rows=torch.from_numpy(rows).to(device),
        vals=vals.reshape(-1)[torch.from_numpy(src).to(device)],
        starts=torch.from_numpy(starts.astype(np.int32)).to(device),
        narrow=narrow, max_slab=int(slabs.max()))


def clear_caches() -> None:
    """Drop every cached row plan and transpose plan (the plain versions'
    memory; the kernels' layouts are ``kernels.qz_reconstruct``'s)."""
    _row_plan.cache_clear()
    _build_transpose_plan.cache_clear()
