"""The one-client backward kernels' host-side pieces, on the CPU.

Kernel 2 (``qz_reconstruct_bwd``, ``scatter_bwd_kernel`` at K=1) and
kernel 5 (``qz_reconstruct_bwd_plan``, ``plan_bwd_kernel`` at K=1) run
only on the card.  What surrounds them is checked here (their K-client
forms in ``tests/test_torch_bwd_batched.py``):

- their launch geometry (``scatter_geometry``, ``plan_geometry``): at
  every shape ``chip_smoke.py`` gives them (Fig. 6's leaves at d in {1,
  16, 256}, Fig. 4's at d=10) and at the ``gpu`` tests' scatter specs,
  every row, edge and coordinate of a window is taken exactly once by
  the kernel's own index arithmetic, replayed here (for the scatter: each
  coordinate pulls, row by row, the one slot j = (c - base) * stride^-1
  mod window that reaches it), and a CTA's shared memory stays under the
  card's per-block limit;
- the compact plan layout (``build_plan_layout``): its entries are the
  padded plan's real entries in order, for both orders, its offsets
  ``cumsum(counts)``, and building it caches no padded plan and no row
  plan;
- the geometry's thread counts are the kernels' own (read from the
  CUDA source);
- a plain walk of the layout, as the kernel walks it, equals
  ``plan_bwd_one_plain`` bit for bit (finite cotangents: the padding
  the layout drops adds +-0), and the JAX kernel in interpret mode
  within ``tests/test_torch_train_ops.py``'s tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import qspec as jq
from repro.kernels import qz_reconstruct as jpk
from repro_torch.configs.mnistfc import MNISTFC
from repro_torch.core import reconstruct as trec
from repro_torch.core.hashrng import fmix32, hash_fold
from repro_torch.core.qspec import (CTR_BASE, CTR_STRIDE, make_qspec,
                                    row_state)
from repro_torch.core import transpose_plan as ttp
from repro_torch.core.transpose_plan import (build_plan_layout,
                                             build_transpose_plan)
from repro_torch.core.zampling import ZamplingConfig, build_specs
from repro_torch.kernels import ops
from repro_torch.kernels.nvcc import (CSRC, SMEM_MAX, magic_div,
                                      source_constant)
from repro_torch.kernels.qz_reconstruct import (PLAN_PIECE_MAX,
                                                PLAN_THREADS, SCATTER_EDGES,
                                                SCATTER_MASK_WORDS,
                                                SCATTER_THREADS,
                                                plan_geometry,
                                                scatter_geometry)
from repro_torch.models.mlp import mlp_template

BOX_MULLER_ATOL = 4.5e-5  # tests/test_torch_train_ops.py's tolerance
SUM_RTOL = 1e-5


def _fig6(d):
    return build_specs(mlp_template(MNISTFC), ZamplingConfig(
        compression=1.0, d=d, window=128, min_size=128, seed=0)).specs


def _fig4():
    return build_specs(mlp_template(MNISTFC), ZamplingConfig(
        compression=8, d=10, window=128, min_size=128, seed=1)).specs


# tests/test_torch_gpu.py's SCATTER_SPECS: (shape, fan_in, compression,
# d, window)
GPU_SPECS = [((6, 112), 6, 8, 8, 16), ((7, 301), 7, 8, 10, 64),
             ((64, 48), 64, 4, 1, 64), ((48, 700), 48, 8, 8, 512),
             ((96, 80), 96, 1, 16, 128), ((24, 40), 24, 1, 256, 512)]


def _shapes():
    out = {}
    for d in (1, 16, 256):
        out.update({f"fig6 {p} d={d}": s for p, s in _fig6(d).items()})
    out.update({f"fig4 {p}": s for p, s in _fig4().items()})
    for i, (shape, fan_in, c, d, window) in enumerate(GPU_SPECS):
        out[f"gpu spec {i}"] = make_qspec(6, shape, fan_in, compression=c,
                                          d=d, window=window, seed=2)
    # the gpu tests' windows of 16384 and 131072 rows
    for shape, c in (((128, 256), 32), ((256, 512), 256)):
        out[f"{shape} at {c}"] = make_qspec(8, shape, shape[0], compression=c,
                                            d=8, window=512, seed=4)
    return out


SHAPES = _shapes()


def _window_rows(spec, w):
    r_lo = w * spec.rows_per_window
    return r_lo, max(r_lo, min(r_lo + spec.rows_per_window, spec.m))


def _windows(spec):
    """The first, a full and the last window (ragged or empty)."""
    return sorted({0, max(0, spec.m // spec.rows_per_window - 1),
                   spec.num_windows - 1})


def _row_streams(spec, rows):
    """(base, stride, the stride's inverse mod 2^32) of rows, as the
    kernel computes them (Newton's iteration for the inverse)."""
    hr = row_state(spec, torch.from_numpy(rows))
    base = (fmix32(hash_fold(hr, CTR_BASE)) & (spec.window - 1)).numpy()
    stride = ((fmix32(hash_fold(hr, CTR_STRIDE)) % (spec.window // 2)) * 2
              + 1).numpy()
    inv = stride.copy()
    for _ in range(3):
        inv = (inv * (2 - stride * inv)) & 0xFFFFFFFF
    return base, stride, inv


@pytest.mark.parametrize("name", list(SHAPES))
def test_scatter_geometry_takes_each_row_edge_and_coordinate_once(name):
    spec = SHAPES[name]
    plan = scatter_geometry(spec.window, spec.rows_per_window, spec.d,
                            spec.num_windows)
    d, win = spec.d, spec.window
    assert plan.ctas == spec.num_windows
    assert plan.threads == SCATTER_THREADS and plan.smem <= SMEM_MAX
    assert plan.chunk_rows * d <= SCATTER_EDGES
    # a coordinate's row mask holds a pass's rows; its stride is odd
    assert plan.mask_stride % 2 == 1
    assert 32 * plan.mask_stride >= plan.chunk_rows
    assert win * plan.mask_stride <= SCATTER_MASK_WORDS
    m_, s1, s2 = (np.uint64(v) for v in plan.div_d)
    for w in _windows(spec):
        r_lo, r_hi = _window_rows(spec, w)
        seen = np.zeros((max(r_hi - r_lo, 1), d), np.int64)
        r0, passes = r_lo, 0
        while True:  # the kernel's pass loop
            nrows = min(plan.chunk_rows, r_hi - r0) if r0 < r_hi else 0
            # a thread per edge e = t + k * threads of the pass's live
            # rows (here all), the row's place in the list e / d by magic
            e = np.arange(nrows * d, dtype=np.uint64)
            t = (e * m_) >> np.uint64(32)
            i = ((t + ((e - t) >> s1)) >> s2).astype(np.int64)
            assert np.array_equal(i, np.arange(nrows * d) // d)
            rows = np.arange(r0, r0 + nrows, dtype=np.int64)
            base, stride, inv = _row_streams(spec, rows)
            j = np.arange(d)
            coord = (base[:, None] + stride[:, None] * j) & (win - 1)
            # each coordinate pulls, row by row in ascending order, the
            # one slot j that reaches it
            c = np.arange(win)
            pull = ((c[None, :] - base[:, None]) * inv[:, None]) & (win - 1)
            ii, cc = np.nonzero(pull < d)  # (row, coordinate) hits
            jj = pull[ii, cc]
            assert np.array_equal(coord[ii, jj], c[cc])
            np.add.at(seen, (r0 - r_lo + ii, jj), 1)
            passes += 1
            if r0 + plan.chunk_rows >= r_hi:
                break
            r0 += plan.chunk_rows
        assert passes <= plan.passes
        assert (seen[:r_hi - r_lo] == 1).all()


@pytest.mark.parametrize("name", list(SHAPES))
def test_plan_geometry_takes_each_entry_once(name):
    spec = SHAPES[name]
    # a window's entries are its rows' edges
    slabs = [np.subtract(*_window_rows(spec, w)[::-1]) * spec.d
             for w in range(spec.num_windows)]
    narrow = spec.rows_per_window <= 1 << 16
    plan = plan_geometry(spec.rows_per_window, spec.num_windows,
                         max(slabs), narrow)
    assert plan.ctas == spec.num_windows and plan.smem <= SMEM_MAX
    assert plan.piece <= PLAN_PIECE_MAX
    for w in _windows(spec):
        s0 = 0
        s1 = slabs[w]
        seen = np.zeros(max(s1, 1), np.int64)
        p0, pieces = s0, 0
        while True:
            n_p = min(plan.piece, s1 - p0)
            seen[p0:p0 + n_p] += 1
            pieces += 1
            if p0 + plan.piece >= s1:
                break
            p0 += plan.piece
        assert pieces <= plan.passes and (seen[:s1] == 1).all()


@pytest.mark.parametrize("name,value", [("SCATTER_THREADS", SCATTER_THREADS),
                                        ("PLAN_THREADS", PLAN_THREADS)])
def test_thread_counts_are_the_kernels_own(name, value):
    text = (CSRC / "qz_reconstruct.cu").read_text()
    assert f"constexpr int {name} = {value};" in text
    assert value % 32 == 0
    with pytest.raises(RuntimeError):
        source_constant("qz_reconstruct.cu", name + "_X")


def test_magic_div_of_every_fig6_degree():
    e = np.arange(SCATTER_EDGES, dtype=np.uint64)
    for d in (1, 10, 16, 64, 256):
        m_, s1, s2 = (np.uint64(v) for v in magic_div(d))
        t = (e * m_) >> np.uint64(32)
        assert np.array_equal((t + ((e - t) >> s1)) >> s2,
                              e // np.uint64(d))


# (shape, fan_in, compression, d, window): Fig. 6's window (128 rows of
# d=16), a ragged last window (422 rows a window, 419 in the last), a
# single window
LAYOUT_SPECS = [((96, 80), 96, 1, 16, 128), ((7, 301), 7, 8, 10, 64),
                ((5, 30), 5, 8, 10, 128)]


def _layout_spec(i):
    shape, fan_in, c, d, window = LAYOUT_SPECS[i]
    return make_qspec(4, shape, fan_in, compression=c, d=d, window=window,
                      seed=3)


@pytest.mark.parametrize("order", ["canonical", "slot"])
@pytest.mark.parametrize("i", range(len(LAYOUT_SPECS)))
def test_layout_is_the_padded_plans_real_entries_in_order(i, order):
    spec = _layout_spec(i)
    # the padded plan it is held against is built here, beside the
    # layout, not taken from a cache an earlier test of the process filled
    ttp.clear_caches()

    def cached():
        return (ttp._build_transpose_plan.cache_info().misses,
                ttp._row_plan.cache_info().misses)

    built = cached()
    lay = build_plan_layout(spec, "cpu", order)
    # the layout comes from the host sort, not from a padded plan, and
    # keeps no row plan
    assert cached() == built
    plan = build_transpose_plan(spec, "cpu", order)
    counts = plan.counts.numpy()
    starts = lay.starts.numpy()
    assert starts.dtype == np.int32 and starts[0] == 0
    assert np.array_equal(starts[1:], np.cumsum(counts))
    assert lay.narrow and lay.rows.dtype == torch.int16
    rows = lay.local_rows()
    vals = lay.vals.numpy()
    assert rows.size == vals.size == spec.m * spec.d
    prow = plan.rows.reshape(spec.n, plan.deg).numpy()
    pval = plan.vals.reshape(spec.n, plan.deg).numpy()
    for c in range(spec.n):
        k = counts[c]
        assert np.array_equal(rows[starts[c]:starts[c + 1]], prow[c, :k])
        assert np.array_equal(vals[starts[c]:starts[c + 1]].view(np.uint32),
                              pval[c, :k].view(np.uint32))
        assert (pval[c, k:] == 0).all()
    slabs = (starts[spec.window::spec.window]
             - starts[:-1:spec.window])
    assert lay.max_slab == slabs.max() == min(
        spec.m, spec.rows_per_window) * spec.d


def _walk(spec, lay, g):
    """The layout walked as plan_bwd_kernel walks it at K=1: each
    coordinate's entries in order, from +0, each multiply and add
    rounded to float32 on its own (numpy float32 arrays do not fuse)."""
    ends = lay.starts.numpy().astype(np.int64)
    starts, counts = ends[:-1], np.diff(ends)
    rows = lay.local_rows()
    vals = lay.vals.numpy()
    row0 = (np.arange(spec.n) // spec.window) * spec.rows_per_window
    acc = np.zeros(spec.n, np.float32)
    for k in range(int(counts.max())):
        live = counts > k
        at = starts[live] + k
        acc[live] = acc[live] + vals[at] * g[row0[live] + rows[at]]
    return acc


@pytest.mark.parametrize("order", ["canonical", "slot"])
@pytest.mark.parametrize("i", range(len(LAYOUT_SPECS)))
def test_layout_walk_equals_plain_bitwise(i, order):
    spec = _layout_spec(i)
    rng = np.random.RandomState(7 + i)
    g = rng.randn(spec.m).astype(np.float32)
    g[::3] = 0.0  # rows whose cotangent is 0
    g[1::7] = -0.0
    g[:spec.rows_per_window] = 0.0  # a whole window of zeros
    lay = build_plan_layout(spec, "cpu", order)
    got = _walk(spec, lay, g)
    want = ops.plan_bwd_one_plain(spec, torch.from_numpy(g), order).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_layout_walk_against_jax_interpret():
    """At a small spec with a ragged last window: the walk against the
    Pallas backward in interpret mode (its own block order, JAX's Q)."""
    shape, fan_in, c, d, window = LAYOUT_SPECS[1]
    spec = make_qspec(4, shape, fan_in, compression=c, d=d, window=window,
                      seed=3)
    j = jq.make_qspec(4, shape, fan_in, compression=c, d=d, window=window,
                      seed=3)
    assert spec.m % spec.rows_per_window  # ragged
    g = np.random.RandomState(5).randn(spec.m).astype(np.float32)
    got = _walk(spec, build_plan_layout(spec, "cpu"), g)
    want = np.asarray(jpk.qz_reconstruct_bwd_plan(j, jnp.asarray(g)),
                      np.float64)
    q = trec.materialize_q(spec)
    ga = torch.from_numpy(np.abs(g))
    tol = (BOX_MULLER_ATOL * spec.sigma * (ga @ (q != 0).to(torch.float32))
           + SUM_RTOL * (ga @ q.abs()) + 1e-7).numpy()
    assert (np.abs(got - want) <= tol).all()
