"""Plain reconstruction ``w = Q z`` and its transpose, in torch.

The JAX package's ``core/reconstruct.py``: the reference the kernels
are held against.  Rows live in a padded per-block space of
``shard_count`` x ``m_pad_loc``; valid rows are the tensor flattened
with ``major_axis`` moved to the front (``_move``/``_unmove``,
``_select_valid``/``_insert_padding`` and their batched forms).

Summation orders are explicit loops, each product and add its own
rounded torch op.  The forward sums a row's d edges in ascending k,
starting at the first product.  The transpose sums a coordinate's
incoming edges starting at +0, in the plan's order (``canonical``: by
source row, then slot k; ``slot``: by k, then row; the plan's padding
entries add 0 * g, a no-op after a +0 start for any finite g).  The
scatter transpose (``grad_z_scatter_ref``) holds no plan: it
regenerates a chunk of windows' rows at a time, on the tensor's device,
bins their edges by coordinate and sums each coordinate's real edges
from +0 in the canonical order, so it equals the canonical plan's
transpose bit for bit (a +0 start never leaves a -0, so the two agree
on signed zeros too; they part only where the cotangent holds an inf
or a NaN, which the plan's padding entries multiply by 0).  The kernels
compute the same orders, which is what lets them equal these functions
bit for bit.  ``grad_z_ref``/``grad_z_batched_ref`` dispatch on the
gate, ``core.transpose_plan.resolve_bwd_path``.
"""

from __future__ import annotations

import torch

from .qspec import (QSpec, padded_row_valid, padded_row_window, row_indices,
                    row_values)
from .transpose_plan import (build_transpose_plan, plan_windows,
                             resolve_bwd_path, row_plan)

# edges the scatter transpose regenerates at once (bounds its temporaries)
_SCATTER_CHUNK_EDGES = 1 << 22


def _move(spec: QSpec, w: torch.Tensor) -> torch.Tensor:
    return w.movedim(spec.major_axis, 0).reshape(-1)


def _unmove(spec: QSpec, flat_moved: torch.Tensor) -> torch.Tensor:
    return flat_moved.reshape(spec.moved_shape).movedim(0, spec.major_axis)


def _move_batched(spec: QSpec, w: torch.Tensor) -> torch.Tensor:
    """(K, *spec.shape) -> (K, m) moved flat order."""
    return w.movedim(spec.major_axis + 1, 1).reshape(w.shape[0], -1)


def _unmove_batched(spec: QSpec, flat_moved: torch.Tensor) -> torch.Tensor:
    """(K, m) moved flat order -> (K, *spec.shape)."""
    k = flat_moved.shape[0]
    return flat_moved.reshape(k, *spec.moved_shape).movedim(
        1, spec.major_axis + 1)


def _select_valid(spec: QSpec, w_pad: torch.Tensor) -> torch.Tensor:
    """(m_pad,) -> (m,) in moved flat order."""
    return w_pad.reshape(spec.shard_count, spec.m_pad_loc)[
        :, :spec.m_blk].reshape(-1)


def _select_valid_batched(spec: QSpec, w_pad: torch.Tensor) -> torch.Tensor:
    """(K, m_pad) -> (K, m) in moved flat order."""
    k = w_pad.shape[0]
    return w_pad.reshape(k, spec.shard_count, spec.m_pad_loc)[
        :, :, :spec.m_blk].reshape(k, spec.m)


def _insert_padding(spec: QSpec, flat_moved: torch.Tensor) -> torch.Tensor:
    """(m,) moved order -> (m_pad,) with per-block padding zeros."""
    blocks = flat_moved.reshape(spec.shard_count, spec.m_blk)
    return torch.nn.functional.pad(
        blocks, (0, spec.m_pad_loc - spec.m_blk)).reshape(-1)


def _insert_padding_batched(spec: QSpec, flat_moved: torch.Tensor):
    """(K, m) moved order -> (K, m_pad) with per-block padding zeros."""
    k = flat_moved.shape[0]
    blocks = flat_moved.reshape(k, spec.shard_count, spec.m_blk)
    return torch.nn.functional.pad(
        blocks, (0, spec.m_pad_loc - spec.m_blk)).reshape(k, spec.m_pad)


def range_real_rows(spec: QSpec, windows, device) -> torch.Tensor:
    """Which padded rows of the range ``windows`` are real (bool, one a
    padded row): in ascending order they are the range's rows of the
    moved flat order."""
    w0, w1 = plan_windows(spec, windows)
    rpw = spec.rows_per_window
    return padded_row_valid(spec, torch.arange(
        w0 * rpw, w1 * rpw, dtype=torch.int64, device=device))


def _rows_sum(vals: torch.Tensor, zg: torch.Tensor) -> torch.Tensor:
    """sum_k vals[..., k] * zg[..., k] in ascending k, from the first
    product (the forward's order)."""
    acc = vals[..., 0] * zg[..., 0]
    for k in range(1, vals.shape[-1]):
        acc = acc + vals[..., k] * zg[..., k]
    return acc


def _edge_sum(vals: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """+0 + sum_e vals[..., e] * g[..., e] in ascending e (the
    transpose's order)."""
    acc = torch.zeros(torch.broadcast_shapes(vals.shape, g.shape)[:-1],
                      dtype=torch.float32, device=g.device)
    for e in range(vals.shape[-1]):
        acc = acc + vals[..., e] * g[..., e]
    return acc


def reconstruct_batched_ref(spec: QSpec, Z: torch.Tensor) -> torch.Tensor:
    """W = Q z^(k) for K stacked clients: Z (K, n) -> (K, *shape) f32."""
    if Z.ndim != 2 or Z.shape[-1] != spec.n:
        raise ValueError(f"Z has shape {tuple(Z.shape)}, spec expects "
                         f"(K, {spec.n})")
    gidx, vals = row_plan(spec, Z.device)
    w_pad = _rows_sum(vals, Z.to(torch.float32)[:, gidx])
    return _unmove_batched(spec, _select_valid_batched(spec, w_pad))


def reconstruct_ref(spec: QSpec, z: torch.Tensor) -> torch.Tensor:
    """w = Q z for one tensor: z (n,) -> weights of spec.shape, f32."""
    if tuple(z.shape) != (spec.n,):
        raise ValueError(f"z has shape {tuple(z.shape)}, spec expects "
                         f"({spec.n},)")
    return reconstruct_batched_ref(spec, z[None])[0]


def plan_apply_batched(spec: QSpec, g_pad: torch.Tensor,
                       order: str = "canonical",
                       windows=None) -> torch.Tensor:
    """Q^T over the ``order`` plan for K cotangents in padded row space:
    (K, m_pad) -> (K, n), each coordinate summing vals * g over its
    plan edges in ascending e from +0.  Over ``windows`` (w0, w1) alone:
    (K, (w1 - w0) * rows_per_window) -> (K, (w1 - w0) * window)."""
    w0, w1 = plan_windows(spec, windows)
    plan = build_transpose_plan(spec, g_pad.device, order, windows)
    k, n = g_pad.shape[0], (w1 - w0) * spec.window
    row0 = torch.arange(w1 - w0, device=g_pad.device)[:, None, None]
    rows = plan.rows.to(torch.int64) + row0 * spec.rows_per_window
    gath = g_pad[:, rows.reshape(-1)].reshape(k, n, plan.deg)
    return _edge_sum(plan.vals.reshape(n, plan.deg), gath)


def scatter_windows(spec: QSpec, g_rows: torch.Tensor, w0: int,
                    w1: int) -> torch.Tensor:
    """The scatter transpose of windows [w0, w1) alone: ``g_rows`` (K,
    (w1 - w0) * rows_per_window) the cotangents of their padded rows ->
    (K, (w1 - w0) * window), their coordinates.

    Window w's rows [w*rpw, (w+1)*rpw) write only into its coordinates.
    Their edges are regenerated on g's device, stably sorted by
    coordinate (which keeps each coordinate's edges in (row, k) order),
    laid out in a degree-padded table whose padding entries read a
    zero, and summed from +0 in ascending order.  Edges of padding rows
    multiply a zero cotangent and add nothing."""
    k, dev = g_rows.shape[0], g_rows.device
    rpw, win, d = spec.rows_per_window, spec.window, spec.d
    g_ext = torch.cat([g_rows.to(torch.float32),
                       torch.zeros((k, 1), dtype=torch.float32, device=dev)],
                      dim=1)  # the last column: the padding entries' zero
    rp = torch.arange(w0 * rpw, w1 * rpw, dtype=torch.int64, device=dev)
    local = padded_row_window(spec, rp) - w0
    key = (local[:, None] * win + row_indices(spec, rp)).reshape(-1)
    vals = row_values(spec, rp).reshape(-1)
    src = (rp - w0 * rpw).repeat_interleave(d)
    ks, perm = torch.sort(key, stable=True)
    cells = (w1 - w0) * win
    counts = torch.bincount(key, minlength=cells)
    deg = max(1, int(counts.max()))
    starts = torch.cumsum(counts, 0) - counts
    slot = ks * deg + (torch.arange(ks.numel(), device=dev) - starts[ks])
    t_rows = torch.full((cells * deg,), rp.numel(), dtype=torch.int64,
                        device=dev)
    t_vals = torch.zeros(cells * deg, dtype=torch.float32, device=dev)
    t_rows[slot] = src[perm]
    t_vals[slot] = vals[perm]
    gath = g_ext[:, t_rows].reshape(k, cells, deg)
    return _edge_sum(t_vals.reshape(cells, deg), gath)


def scatter_apply_batched(spec: QSpec, g_pad: torch.Tensor,
                          windows=None) -> torch.Tensor:
    """Q^T for K cotangents in padded row space by the scatter: (K,
    m_pad) -> (K, n), holding no row plan and no transpose plan: a chunk
    of windows at a time through ``scatter_windows``.  Over ``windows``
    (w0, w1) alone: (K, (w1 - w0) * rows_per_window) -> (K, (w1 - w0) *
    window)."""
    lo, hi = plan_windows(spec, windows)
    rpw, win = spec.rows_per_window, spec.window
    out = torch.empty((g_pad.shape[0], (hi - lo) * win),
                      dtype=torch.float32, device=g_pad.device)
    per = max(1, _SCATTER_CHUNK_EDGES // (rpw * spec.d))
    for w0 in range(lo, hi, per):
        w1 = min(hi, w0 + per)
        out[:, (w0 - lo) * win:(w1 - lo) * win] = scatter_windows(
            spec, g_pad[:, (w0 - lo) * rpw:(w1 - lo) * rpw], w0, w1)
    return out


def grad_z_plan_batched_ref(spec: QSpec, grad_W: torch.Tensor,
                            order: str = "canonical"):
    """Per-client Q^T grad_w over the plan: (K, *shape) -> (K, n) f32."""
    g_pad = _insert_padding_batched(
        spec, _move_batched(spec, grad_W.to(torch.float32)))
    return plan_apply_batched(spec, g_pad, order)


def grad_z_plan_ref(spec: QSpec, grad_w: torch.Tensor,
                    order: str = "canonical") -> torch.Tensor:
    """Q^T grad_w over the plan for one tensor: shape -> (n,) f32."""
    return grad_z_plan_batched_ref(spec, grad_w[None], order)[0]


def grad_z_scatter_batched_ref(spec: QSpec, grad_W: torch.Tensor):
    """Per-client Q^T grad_w by the scatter: (K, *shape) -> (K, n) f32."""
    g_pad = _insert_padding_batched(
        spec, _move_batched(spec, grad_W.to(torch.float32)))
    return scatter_apply_batched(spec, g_pad)


def grad_z_scatter_ref(spec: QSpec, grad_w: torch.Tensor) -> torch.Tensor:
    """Q^T grad_w by the scatter for one tensor: shape -> (n,) f32."""
    return grad_z_scatter_batched_ref(spec, grad_w[None])[0]


def grad_z_batched_ref(spec: QSpec, grad_W: torch.Tensor) -> torch.Tensor:
    """Q^T grad_w per client, plan or scatter as the gate says."""
    kind, order = resolve_bwd_path()
    if kind == "plan":
        return grad_z_plan_batched_ref(spec, grad_W, order)
    return grad_z_scatter_batched_ref(spec, grad_W)


def grad_z_ref(spec: QSpec, grad_w: torch.Tensor) -> torch.Tensor:
    """Q^T grad_w for one tensor, plan or scatter as the gate says."""
    return grad_z_batched_ref(spec, grad_w[None])[0]


def materialize_q(spec: QSpec, device="cpu") -> torch.Tensor:
    """Dense (m, n) Q in natural (spec.shape row-major) order — tests
    and small-scale checks only."""
    gidx, vals = row_plan(spec, device)
    rows = torch.arange(spec.m_pad, device=gidx.device)[:, None].expand_as(
        gidx)
    q_pad = torch.zeros((spec.m_pad, spec.n), dtype=torch.float32,
                        device=gidx.device)
    q_pad.index_put_((rows, gidx), vals, accumulate=True)
    q_moved = q_pad.reshape(spec.shard_count, spec.m_pad_loc, spec.n)[
        :, :spec.m_blk].reshape(*spec.moved_shape, spec.n)
    return q_moved.movedim(0, spec.major_axis).reshape(spec.m, spec.n)
