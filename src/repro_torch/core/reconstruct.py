"""Plain reconstruction ``w = Q z`` and its transpose, in torch.

The JAX package's ``core/reconstruct.py``: the reference the kernels
are held against.  Rows live in a padded per-block space of
``shard_count`` x ``m_pad_loc``; valid rows are the tensor flattened
with ``major_axis`` moved to the front (``_move``/``_unmove``,
``_select_valid``/``_insert_padding`` and their batched forms).

Summation orders are explicit loops, each product and add its own
rounded torch op: the forward sums a row's d edges in ascending k, the
transpose sums a coordinate's plan edges in ascending e (the canonical
order of ``core.transpose_plan``).  The kernels compute the same
orders, which is what lets them equal these functions bit for bit.
"""

from __future__ import annotations

import torch

from .qspec import QSpec
from .transpose_plan import build_transpose_plan, row_plan


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


def _rows_sum(vals: torch.Tensor, zg: torch.Tensor) -> torch.Tensor:
    """sum_k vals[..., k] * zg[..., k] in ascending k."""
    acc = vals[..., 0] * zg[..., 0]
    for k in range(1, vals.shape[-1]):
        acc = acc + vals[..., k] * zg[..., k]
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


def plan_apply_batched(spec: QSpec, g_pad: torch.Tensor) -> torch.Tensor:
    """Q^T over the canonical plan for K cotangents in padded row space:
    (K, m_pad) -> (K, n), each coordinate summing vals * g over its
    plan edges in ascending e (padding entries add exact zeros)."""
    plan = build_transpose_plan(spec, g_pad.device)
    k = g_pad.shape[0]
    row0 = torch.arange(spec.num_windows, device=g_pad.device)[:, None, None]
    rows = plan.rows.to(torch.int64) + row0 * spec.rows_per_window
    gath = g_pad[:, rows.reshape(-1)].reshape(k, spec.n, plan.deg)
    return _rows_sum(plan.vals.reshape(spec.n, plan.deg), gath)


def grad_z_plan_batched_ref(spec: QSpec, grad_W: torch.Tensor):
    """Per-client Q^T grad_w over the plan: (K, *shape) -> (K, n) f32."""
    g_pad = _insert_padding_batched(
        spec, _move_batched(spec, grad_W.to(torch.float32)))
    return plan_apply_batched(spec, g_pad)


def grad_z_plan_ref(spec: QSpec, grad_w: torch.Tensor) -> torch.Tensor:
    """Q^T grad_w over the plan for one tensor: shape -> (n,) f32."""
    return grad_z_plan_batched_ref(spec, grad_w[None])[0]


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
