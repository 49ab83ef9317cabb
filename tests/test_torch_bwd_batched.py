"""The K-client backward kernels' host-side pieces, on the CPU.

Kernel 6 (``qz_reconstruct_batched_bwd_plan``) is ``plan_bwd_kernel`` and
kernel 4 (``qz_reconstruct_batched_bwd``) is ``scatter_bwd_kernel``, at K
clients; kernels 5 and 2 are the same bodies at K=1.  They run only on
the card.  What surrounds them is checked here:

- the K-client geometry of both bodies (``plan_geometry``,
  ``scatter_geometry``) at Fig. 4's three leaves (K=10), at full-width
  qwen2-0.5b's leaves (K=4) and at a ``gpu`` test spec at K=33 (several
  client groups and sweeps): replaying the kernels' own loops over the
  first, a full and the last window, each (entry, client) of a window's
  slab and each (edge, client) of its rows is taken exactly once, and a
  CTA's shared memory stays under the card's limit.  Only ``make_qspec``
  arithmetic and the row hash: no layout is built;
- a numpy walk of the compact layout, as ``plan_bwd_kernel`` walks it
  (pieces, staged client groups, (coordinate, G clients) pairs), equals
  ``plan_bwd_plain`` bit for bit at K in {1, 3, 10}, in both orders;
- a numpy row-mask pull, as ``scatter_bwd_kernel`` pulls (sweeps, passes,
  live rows, (coordinate, client group) pairs), equals
  ``scatter_bwd_plain`` bit for bit, with rows dead for some clients and
  for all, and -0 cotangents;
- both against JAX's batched kernels in interpret mode at a small spec
  with a ragged last window, within ``tests/test_torch_train_ops.py``'s
  tolerance;
- the padding difference: with an Inf cotangent at a window's row 0,
  the layout walk and ``plan_bwd_plain`` differ exactly at that window's
  padded coordinates (NaN in the plain version).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import qspec as jq
from repro.kernels import qz_reconstruct as jpk
from repro_torch.configs import get_arch
from repro_torch.configs.mnistfc import MNISTFC
from repro_torch.core import reconstruct as trec
from repro_torch.core.hashrng import fmix32, hash_fold
from repro_torch.core.qspec import (CTR_BASE, CTR_STRIDE, make_qspec,
                                    row_state, row_values)
from repro_torch.core.transpose_plan import (build_plan_layout,
                                             build_transpose_plan)
from repro_torch.core.zampling import ZamplingConfig, build_specs
from repro_torch.kernels import ops
from repro_torch.kernels.nvcc import SMEM_MAX
from repro_torch.kernels.qz_reconstruct import (PLAN_PIECE_MAX,
                                                PLAN_STAGE_FLOATS,
                                                PLAN_THREADS,
                                                SCATTER_EDGES,
                                                SCATTER_GROUPS,
                                                SCATTER_MASK_WORDS,
                                                SCATTER_THREADS,
                                                plan_geometry,
                                                scatter_geometry,
                                                scatter_words)
from repro_torch.models.mlp import mlp_template
from repro_torch.models.model import param_template

BOX_MULLER_ATOL = 4.5e-5  # tests/test_torch_train_ops.py's tolerance
SUM_RTOL = 1e-5


def _geometry_cases():
    out = {}
    fig4 = build_specs(mlp_template(MNISTFC), ZamplingConfig(
        compression=8, d=10, window=128, min_size=128, seed=1)).specs
    out.update({f"fig4 {p} K=10": (s, 10) for p, s in fig4.items()})
    lm = build_specs(param_template(get_arch("qwen2-0.5b")), ZamplingConfig(
        compression=8, d=8, min_size=4096)).specs  # launch/train.py's
    out.update({f"qwen2-0.5b {p} K=4": (s, 4) for p, s in lm.items()})
    # tests/test_torch_gpu.py's SCATTER_SPECS[3] at its largest K
    out["gpu spec 3 K=33"] = (make_qspec(6, (48, 700), 48, compression=8,
                                         d=8, window=512, seed=2), 33)
    return out


GEOMETRY_CASES = _geometry_cases()


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


# --- plan_bwd_kernel's loops ---------------------------------------------


def _plan_pairs(geo, starts, K):
    """plan_bwd_kernel's loops over one window whose slab's coordinate
    lists are [starts[c], starts[c+1]) (window-local): per piece and
    staged client group, its (coordinate, G clients) pairs, coordinate
    fastest, as (p0, first piece?, k0, c, k, lo, hi), one item a (pair,
    client): client k0 + k[i] at coordinate c[i] adds entries
    [lo[i], hi[i])."""
    win = starts.size - 1
    s0, s1 = int(starts[0]), int(starts[-1])
    p0 = s0
    while True:
        n_p = min(geo.piece, s1 - p0)
        for k0 in range(0, K, geo.stage):
            kn = min(geo.stage, K - k0)
            q = np.arange(win * -(-kn // geo.group))
            c, k1 = q % win, (q // win) * geo.group
            k = (k1[:, None] + np.arange(geo.group)).reshape(-1)
            c = np.repeat(c, geo.group)
            c, k = c[k < kn], k[k < kn]  # a group's clients past kn: none
            lo = np.maximum(starts[c], p0)
            hi = np.minimum(starts[c + 1], p0 + n_p)
            yield p0, p0 == s0, k0, c, k, lo, hi
        if p0 + geo.piece >= s1:
            break
        p0 += geo.piece


def _plan_walk(spec, lay, geo, G):
    """(K, n) f32: the layout walked as plan_bwd_kernel walks it; each
    sum from +0 (or the partial sum of the last piece) in list order,
    each multiply and add rounded to float32 on its own (numpy float32
    arrays do not fuse)."""
    K, win = G.shape[0], spec.window
    ends = lay.starts.numpy().astype(np.int64)
    rows, vals = lay.local_rows(), lay.vals.numpy()
    out = np.empty((K, spec.n), np.float32)
    for w in range(spec.num_windows):
        c0, r0 = w * win, w * spec.rows_per_window
        for _, first, k0, c, k, lo, hi in _plan_pairs(
                geo, ends[c0:c0 + win + 1], K):
            acc = (np.zeros(c.size, np.float32) if first
                   else out[k0 + k, c0 + c])
            for t in range(int((hi - lo).max(initial=0))):
                live = lo + t < hi
                e = lo[live] + t
                acc[live] = acc[live] + vals[e] * G[k0 + k[live],
                                                    r0 + rows[e]]
            out[k0 + k, c0 + c] = acc
    return out


# --- scatter_bwd_kernel's loops ------------------------------------------


def _scatter_passes(geo, r_lo, r_hi, K):
    """scatter_bwd_kernel's sweeps and passes over one window's rows:
    (k0, kn, [(r0, nrows, last), ...]) per sweep."""
    for k0 in range(0, K, geo.clients):
        passes, r0 = [], r_lo
        while True:
            nrows = min(geo.chunk_rows, r_hi - r0) if r0 < r_hi else 0
            last = r0 + geo.chunk_rows >= r_hi
            passes.append((r0, nrows, last))
            if last:
                break
            r0 += geo.chunk_rows
        yield k0, min(geo.clients, K - k0), passes


def _walk_pairs(geo, win, kn):
    """The walk's (coordinate, client group) pairs of a sweep: how many
    times each (client, coordinate) is summed, (kn, win)."""
    took = np.zeros((kn, win), np.int64)
    pairs = win * -(-kn // geo.group)
    for p in range(pairs):
        c, k1 = p % win, (p // win) * geo.group
        for g in range(geo.group):
            if k1 + g < kn:
                took[k1 + g, c] += 1
    return took


def _pulls(spec, rows):
    """Each (coordinate, row) hit of ``rows`` (ascending), coordinate
    major and ascending row within a coordinate, as the walk pulls them:
    (coordinate, index into rows, slot j, rank within the coordinate)."""
    win = spec.window
    base, stride, inv = _row_streams(spec, rows)
    c = np.arange(win)
    pull = ((c[None, :] - base[:, None]) * inv[:, None]) & (win - 1)
    cc, ii = np.nonzero(pull.T < spec.d)
    jj = pull[ii, cc]
    # row i reaches coordinate c at slot j and nowhere else
    assert np.array_equal((base[ii] + stride[ii] * jj) & (win - 1), cc)
    counts = np.bincount(cc, minlength=win)
    rank = np.arange(cc.size) - (np.cumsum(counts) - counts)[cc]
    return cc, ii, jj, rank


def _scatter_walk(spec, geo, G):
    """(K, n) f32: Q^T G as scatter_bwd_kernel computes it: per pass the
    rows some client of the sweep carries, each coordinate's rows in
    ascending order, value * g_k[row] rounded on its own and added to
    client k's sum from +0."""
    K, win = G.shape[0], spec.window
    out = np.empty((K, spec.n), np.float32)
    for w in range(spec.num_windows):
        for k0, kn, passes in _scatter_passes(geo, *_window_rows(spec, w),
                                              K):
            acc = np.zeros((kn, win), np.float32)
            for r0, nrows, _ in passes:
                g = G[k0:k0 + kn, r0:r0 + nrows]
                live = np.nonzero((g != 0).any(0))[0]
                if live.size == 0:
                    continue
                rows = r0 + live
                vals = row_values(spec, torch.from_numpy(rows)).numpy()
                cc, ii, jj, rank = _pulls(spec, rows)
                for t in range(int(rank.max(initial=-1)) + 1):
                    s = rank == t
                    acc[:, cc[s]] = acc[:, cc[s]] + (
                        vals[ii[s], jj[s]][None, :] * g[:, live[ii[s]]])
            out[k0:k0 + kn, w * win:(w + 1) * win] = acc
    return out


# --- the geometry, from the spec's arithmetic ------------------------------


@pytest.mark.parametrize("name", list(GEOMETRY_CASES))
def test_scatter_geometry_takes_each_edge_and_client_once(name):
    spec, K = GEOMETRY_CASES[name]
    geo = scatter_geometry(spec.window, spec.rows_per_window, spec.d,
                           spec.num_windows, K)
    d, win = spec.d, spec.window
    assert geo.ctas == spec.num_windows and geo.threads == SCATTER_THREADS
    assert geo.smem <= SMEM_MAX and geo.chunk_rows * d <= SCATTER_EDGES
    assert geo.smem == 4 * scatter_words(
        win, spec.rows_per_window, geo.mask_stride, geo.chunk_rows, d,
        geo.clients, geo.group)
    assert geo.mask_stride % 2 == 1 and 32 * geo.mask_stride >= geo.chunk_rows
    assert win * geo.mask_stride <= SCATTER_MASK_WORDS
    assert geo.group in SCATTER_GROUPS and geo.group >= min(K, 8)
    assert 1 <= geo.clients <= K and geo.sweeps == -(-K // geo.clients)
    m_, s1, s2 = (np.uint64(v) for v in geo.div_d)
    for w in _windows(spec):
        r_lo, r_hi = _window_rows(spec, w)
        seen = np.zeros((max(r_hi - r_lo, 1), d, K), np.int64)
        sweeps = 0
        for k0, kn, passes in _scatter_passes(geo, r_lo, r_hi, K):
            sweeps += 1
            took = _walk_pairs(geo, win, kn)
            assert (took == 1).all()  # each (client, coordinate) once
            assert len(passes) <= geo.passes
            for r0, nrows, _ in passes:
                # a thread per edge of the live rows (here all): the
                # row's place in the list e / d by magic division
                e = np.arange(nrows * d, dtype=np.uint64)
                t = (e * m_) >> np.uint64(32)
                li = ((t + ((e - t) >> s1)) >> s2).astype(np.int64)
                assert np.array_equal(li, np.arange(nrows * d) // d)
                rows = np.arange(r0, r0 + nrows, dtype=np.int64)
                if nrows == 0:
                    continue
                cc, ii, jj, _ = _pulls(spec, rows)
                hits = np.zeros((nrows, d), np.int64)
                np.add.at(hits, (ii, jj), 1)
                seen[r0 - r_lo:r0 - r_lo + nrows, :, k0:k0 + kn] += (
                    hits[:, :, None])
        assert sweeps == geo.sweeps
        assert (seen[:r_hi - r_lo] == 1).all()


@pytest.mark.parametrize("name", list(GEOMETRY_CASES))
def test_plan_geometry_takes_each_entry_and_client_once(name):
    spec, K = GEOMETRY_CASES[name]
    win, d = spec.window, spec.d
    slabs = [np.subtract(*_window_rows(spec, w)[::-1]) * d
             for w in range(spec.num_windows)]
    narrow = spec.rows_per_window <= 1 << 16
    geo = plan_geometry(spec.rows_per_window, spec.num_windows, max(slabs),
                        narrow, K)
    assert geo.ctas == spec.num_windows and geo.threads == PLAN_THREADS
    assert geo.smem <= SMEM_MAX and geo.piece <= PLAN_PIECE_MAX
    g_stride = spec.rows_per_window | 1
    if geo.stage_g:
        assert g_stride % 2 == 1 and geo.stage * g_stride <= PLAN_STAGE_FLOATS
    else:
        assert geo.stage == K
    assert geo.group in SCATTER_GROUPS and geo.group >= min(K, 8)
    # a piece's values and rows (one row more: uint16 rows copy as words)
    assert geo.smem == geo.piece * (4 + geo.row_bytes) + 4 + (
        4 * geo.stage * g_stride if geo.stage_g else 0)
    assert geo.stages == -(-K // geo.stage)
    for w in _windows(spec):
        r_lo, r_hi = _window_rows(spec, w)
        rows = np.arange(r_lo, r_hi, dtype=np.int64)
        base, stride, _ = _row_streams(spec, rows)
        coord = (base[:, None] + stride[:, None] * np.arange(d)) & (win - 1)
        counts = np.bincount(coord.reshape(-1), minlength=win)
        starts = np.concatenate(([0], np.cumsum(counts)))
        assert starts[-1] == slabs[w]
        seen = np.zeros((max(slabs[w], 1), K), np.int64)
        pieces = set()
        for p0, _, k0, c, k, lo, hi in _plan_pairs(geo, starts, K):
            pieces.add(p0)
            n = np.maximum(hi - lo, 0)
            e = np.repeat(lo, n) + (np.arange(n.sum())
                                    - np.repeat(np.cumsum(n) - n, n))
            np.add.at(seen, (e, np.repeat(k0 + k, n)), 1)
        assert len(pieces) <= geo.passes
        assert (seen[:slabs[w]] == 1).all()


# --- the walks against the plain versions and JAX -------------------------

# (shape, fan_in, compression, d, window): Fig. 6's window (128 rows of
# d=16), a ragged last window (422 rows a window, 419 in the last), a
# single window
SMALL_SPECS = [((96, 80), 96, 1, 16, 128), ((7, 301), 7, 8, 10, 64),
               ((5, 30), 5, 8, 10, 128)]


def _small_spec(i):
    shape, fan_in, c, d, window = SMALL_SPECS[i]
    return make_qspec(4, shape, fan_in, compression=c, d=d, window=window,
                      seed=3)


def _cotangents(spec, K, seed):
    """(K, m) f32 with rows 0 for every client, rows 0 for some, -0
    entries and a whole window of zeros."""
    rng = np.random.RandomState(seed)
    G = rng.randn(K, spec.m).astype(np.float32)
    G[:, ::3] = 0.0  # dead for every client
    G[rng.rand(K, spec.m) < 0.3] = 0.0  # dead for some
    G[:, 1::7] = -0.0
    G[:, :spec.rows_per_window] = 0.0
    return G


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("order", ["canonical", "slot"])
@pytest.mark.parametrize("K", [1, 3, 10])
@pytest.mark.parametrize("i", range(len(SMALL_SPECS)))
def test_layout_walk_equals_plain_bitwise(i, K, order):
    spec = _small_spec(i)
    G = _cotangents(spec, K, 11 + i)
    lay = build_plan_layout(spec, "cpu", order)
    want = _bits(ops.plan_bwd_plain(spec, torch.from_numpy(G), order))
    geo = plan_geometry(spec.rows_per_window, spec.num_windows, lay.max_slab,
                        lay.narrow, K)
    # as built, and with a window's slab in three pieces and clients two
    # at a time, so sums carry over pieces and groups loop
    piece = -(-lay.max_slab // 3)
    small = geo._replace(piece=piece, passes=-(-lay.max_slab // piece),
                         stage=min(K, 2), stages=-(-K // min(K, 2)))
    for g in (geo, small):
        assert np.array_equal(_bits(_plan_walk(spec, lay, g, G)), want)


@pytest.mark.parametrize("K", [1, 3, 10])
@pytest.mark.parametrize("i", range(len(SMALL_SPECS)))
def test_row_mask_pull_equals_plain_bitwise(i, K):
    spec = _small_spec(i)
    G = _cotangents(spec, K, 21 + i)
    want = _bits(ops.scatter_bwd_plain(spec, torch.from_numpy(G)))
    geo = scatter_geometry(spec.window, spec.rows_per_window, spec.d,
                           spec.num_windows, K)
    # as built, and with a window's rows in three passes and sweeps of
    # two clients
    rows = -(-spec.rows_per_window // 3)
    small = geo._replace(chunk_rows=rows, mask_stride=-(-rows // 32) | 1,
                         clients=min(K, 2), group=min(K, 2))
    for g in (geo, small):
        assert np.array_equal(_bits(_scatter_walk(spec, g, G)), want)


def test_walks_against_jax_interpret():
    """At a small spec with a ragged last window: both walks against the
    Pallas batched backwards in interpret mode (their own block order,
    JAX's Q)."""
    shape, fan_in, c, d, window = SMALL_SPECS[1]
    spec = _small_spec(1)
    j = jq.make_qspec(4, shape, fan_in, compression=c, d=d, window=window,
                      seed=3)
    assert spec.m % spec.rows_per_window  # ragged
    K = 3
    G = np.random.RandomState(5).randn(K, spec.m).astype(np.float32)
    G[0, ::2] = 0.0
    lay = build_plan_layout(spec, "cpu")
    plan = _plan_walk(spec, lay, plan_geometry(
        spec.rows_per_window, spec.num_windows, lay.max_slab, lay.narrow, K),
        G)
    scat = _scatter_walk(spec, scatter_geometry(
        spec.window, spec.rows_per_window, spec.d, spec.num_windows, K), G)
    want_plan = np.asarray(jpk.qz_reconstruct_batched_bwd_plan(
        j, jnp.asarray(G)), np.float64)
    want_scat = np.asarray(jpk.qz_reconstruct_batched_bwd(
        j, jnp.asarray(G)), np.float64)
    q = trec.materialize_q(spec)
    ga = torch.from_numpy(np.abs(G))
    tol = (BOX_MULLER_ATOL * spec.sigma * (ga @ (q != 0).to(torch.float32))
           + SUM_RTOL * (ga @ q.abs()) + 1e-7).numpy()
    for got, want in ((plan, want_plan), (scat, want_scat)):
        assert (np.abs(got - want) <= tol).all()


def test_inf_cotangent_differs_from_plain_at_padded_coordinates():
    spec = _small_spec(1)
    K, k, w = 3, 1, 1
    G = np.random.RandomState(9).randn(K, spec.m).astype(np.float32)
    G[k, w * spec.rows_per_window] = np.inf  # the window's row 0
    lay = build_plan_layout(spec, "cpu")
    got = _plan_walk(spec, lay, plan_geometry(
        spec.rows_per_window, spec.num_windows, lay.max_slab, lay.narrow, K),
        G)
    plain = ops.plan_bwd_plain(spec, torch.from_numpy(G)).numpy()
    counts = build_transpose_plan(spec, "cpu").counts.numpy()
    deg = int(counts.max())
    padded = np.zeros((K, spec.n), bool)
    cw = slice(w * spec.window, (w + 1) * spec.window)
    padded[k, cw] = counts[cw] < deg
    assert padded.any() and not padded.all()
    assert np.isnan(plain[padded]).all()
    assert np.array_equal(_bits(got) != _bits(plain), padded)
    # the walk is the scatter's sum, padding or not
    assert np.array_equal(_bits(got), _bits(ops.scatter_bwd_plain(
        spec, torch.from_numpy(G))))
