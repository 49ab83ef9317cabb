"""The serve kernel's launch geometry and exact divisions, on the CPU.

``kernels.qz_decode.serve_plan`` cuts each group into tiles of output
columns, all input rows each, that the CTAs of a cooperative grid take in
turn, regenerate into shared memory and walk; the kernel takes what it
returns.  At the 8 serving shapes of qwen2-0.5b (B in {1, 4, 128}) and at
the shapes of the ``gpu`` tests, every (input row, column) of a tile must
be regenerated exactly once and every (batch row, column) walked once, a
CTA's shared memory must hold the tile and the scratch of both phases
within the card's limit, and every serving launch must have at least 2
CTAs for each of the 132 SMs.  ``magic_div`` must divide exactly.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.qspec import make_qspec
from repro_torch.core.zampling import ZamplingConfig, build_specs
from repro_torch.kernels import ops
from repro_torch.kernels.qz_decode import (CO_MAX, REGEN_BYTES, SMEM_MAX,
                                           SMS, magic_div, serve_plan)
from repro_torch.models.model import param_template

SERVE_PATHS = ("blocks/attn/wq", "blocks/attn/wk", "blocks/attn/wv",
               "blocks/attn/wo", "blocks/mlp/gate", "blocks/mlp/up",
               "blocks/mlp/down", "lm_head")
GPU_SHAPES = [(2, 640, 384), (3, 200, 1001), (1, 300, 16037), (2, 96, 128),
              (5, 71, 100)]


def _serving_specs():
    zspecs = build_specs(param_template(get_arch("qwen2-0.5b")),
                         ZamplingConfig(compression=8, d=8, min_size=65536))
    return {path: zspecs.specs[path] for path in SERVE_PATHS}


SERVING = _serving_specs()


def _check_plan(d_in, d_out, B, d, rpw):
    """Every entry of every tile regenerated once and walked once, and
    the scratch of both phases inside the CTA's shared memory."""
    plan = serve_plan(d_in, d_out, B, d, rpw, ops.SERVE_BM)
    assert plan.co & (plan.co - 1) == 0 and plan.co <= CO_MAX
    assert plan.tiles == -(-d_out // plan.co)
    assert plan.rows % 8 == 0 and d_in <= plan.rows < d_in + 8
    assert plan.chunk % 8 == 0 and plan.smem <= SMEM_MAX
    scratch = plan.smem - 4 * plan.rows * plan.co
    assert scratch >= (4 * (B * plan.chunk + 2 * B * plan.co)
                       + plan.co * plan.chunk)
    assert scratch >= (REGEN_BYTES if d == 8 else 0)
    assert plan.all_flush == (d_out >= ops.SERVE_BM)
    # the kernel's entry e = row * co + column of a tile, and its walk's
    # chains q = batch row * co + column, at the first and the last
    # (ragged) tile; the others are the first's
    e = np.arange(plan.rows * plan.co)
    i, col = e // plan.co, e % plan.co
    for t in sorted({0, plan.tiles - 1}):
        o0 = t * plan.co
        width = min(plan.co, d_out - o0)
        live = (i < d_in) & (col < width)
        hits = np.zeros((d_in, plan.co), np.int64)
        np.add.at(hits, (i[live], col[live]), 1)
        assert (hits[:, :width] == 1).all() and (hits[:, width:] == 0).all()
        q = np.arange(B * plan.co)
        walked = o0 + q % plan.co
        assert np.array_equal(np.bincount(walked[walked < d_out] - o0,
                                          minlength=width), np.full(width, B))
    # the tiles cover the columns once
    assert (plan.tiles - 1) * plan.co < d_out <= plan.tiles * plan.co
    return plan


@pytest.mark.parametrize("path", SERVE_PATHS)
def test_serving_plan_covers_and_fills_the_card(path):
    spec = SERVING[path]
    _, d_in, d_out = ops.serve_group_dims(spec)
    for B in (1, 4, 128):
        plan = _check_plan(d_in, d_out, B, spec.d, spec.rows_per_window)
        assert plan.ctas >= 2 * SMS, (path, B, plan)
        # every CTA finds work after phase 1 but at the narrow 128-column
        # leaves (one tile a column)
        assert plan.tiles >= min(d_out, plan.ctas), (path, B, plan)


@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_gpu_case_plan_covers(shape):
    for d in (1, 8, 16):
        spec = make_qspec(7, shape, shape[1], compression=8, d=d)
        _, d_in, d_out = ops.serve_group_dims(spec)
        for B in (1, 2, 3, 4, 5, 128):
            _check_plan(d_in, d_out, B, spec.d, spec.rows_per_window)


@pytest.mark.parametrize("shape", GPU_SHAPES + [(24, 896, 896)])
def test_every_row_flushes_where_d_out_reaches_bm(shape):
    """The kernel adds each product straight into y where d_out >= bm:
    rows i and i + 1 of a column then never share a canonical block."""
    spec = make_qspec(7, shape, shape[1], compression=8, d=8)
    _, d_in, d_out = ops.serve_group_dims(spec)
    r = torch.from_numpy(
        np.random.RandomState(0).randint(0, spec.m - d_out, 4096))
    same = ops.serve_block_of(spec, r, ops.SERVE_BM) == ops.serve_block_of(
        spec, r + d_out, ops.SERVE_BM)
    assert bool(same.any()) == (d_out < ops.SERVE_BM)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 255, 256, 3500, 3945, 4086, 4096,
                               65535, (1 << 31) - 1, 1 << 31, (1 << 32) - 1])
def test_magic_div_exact(d):
    m, s1, s2 = magic_div(d)
    assert 0 < m < 1 << 32
    rng = np.random.RandomState(d & 0xFFFF)
    # random words, the edges of the range, and each side of the top
    # multiples of d
    k = np.arange(max(0, (1 << 32) // d - 4), (1 << 32) // d + 1,
                  dtype=np.uint64) * np.uint64(d)
    n = np.concatenate([
        rng.randint(0, 1 << 32, 20000, dtype=np.uint64),
        np.array([0, 1, d - 1, d, d + 1, (1 << 31) - 1, 1 << 31,
                  (1 << 32) - 1], dtype=np.uint64),
        k, k - np.uint64(1), k + np.uint64(d - 1)])
    n = n[n < np.uint64(1 << 32)]
    t = (n * np.uint64(m)) >> np.uint64(32)
    q = (t + ((n - t) >> np.uint64(s1))) >> np.uint64(s2)
    assert np.array_equal(q, n // np.uint64(d))
