"""The forward kernels' host-side pieces, on the CPU.

Kernels 8 (``qz_sample_reconstruct_batched_fwd``) and 3
(``qz_reconstruct_batched_fwd``) are one body, ``reconstruct_window``,
drawing or staging its operand; kernels 7 and 1 are its K=1 launches.
It runs only on the card.  What surrounds it is checked here:

- its geometry (``reconstruct_geometry``) at Fig. 4's three leaves
  (K=10), Fig. 6's leaves at d in {1, 16, 256} (K=1), full-width
  qwen2-0.5b's 12 leaves (K=4) and a ``gpu`` test spec at K=33 (two
  client words, two groups): replaying the body's loops over the first,
  a full and the last window (ragged or empty), each (row, client) is
  written exactly once, each (coordinate, client) is staged once a CTA
  and sweep, and a CTA's shared memory stays under the card's limit.
  Only ``make_qspec`` arithmetic;
- a numpy emulation of the body (window slices, sweeps of clients, the
  bits in words of 32 clients, groups of G clients at a shift in their
  word, skipped batches of dead edges, the bits' path an explicit operand of masks
  takes, the sign rule for a (row, client) whose products are all +-0)
  equals ``sample_reconstruct_plain`` (f32, u8 and u16 operands) and
  ``reconstruct_plain`` (masks, and operands holding +-0 and negatives)
  by uint32 bits at K in {1, 3, 10, 33} and d in {1, 10, 16}, with a
  client whose probabilities (or operands) are 0 over a whole window;
- against JAX's batched forwards in interpret mode at a small spec with
  a ragged last window: the staged mask bits exactly, the sums within
  ``tests/test_torch_train_ops.py``'s tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import qspec as jq, sampling as js
from repro.kernels import qz_reconstruct as jpk
from repro_torch.configs import get_arch
from repro_torch.configs.mnistfc import MNISTFC
from repro_torch.core.hashrng import bernoulli_u32
from repro_torch.core.qspec import make_qspec, row_indices, row_values
from repro_torch.core.sampling import (as_words, mask_u32,
                                       quant_threshold_u24, word_values)
from repro_torch.core.zampling import ZamplingConfig, build_specs
from repro_torch.kernels import ops
from repro_torch.kernels.nvcc import SMEM_MAX, source_constant
from repro_torch.kernels.qz_reconstruct import (FWD_GROUPS, FWD_ROWS_MIN,
                                                FWD_STAGE_WORDS,
                                                FWD_TARGET_CTAS, FWD_THREADS,
                                                fwd_words,
                                                reconstruct_geometry)
from repro_torch.models.mlp import mlp_template
from repro_torch.models.model import param_template

BOX_MULLER_ATOL = 4.5e-5  # tests/test_torch_train_ops.py's tolerance
FWD_EDGE_ILP = source_constant("qz_reconstruct.cu", "FWD_EDGE_ILP")


def _geometry_cases():
    out = {}
    fig4 = build_specs(mlp_template(MNISTFC), ZamplingConfig(
        compression=8, d=10, window=128, min_size=128, seed=1)).specs
    out.update({f"fig4 {p} K=10": (s, 10) for p, s in fig4.items()})
    for d in (1, 16, 256):
        fig6 = build_specs(mlp_template(MNISTFC), ZamplingConfig(
            compression=1.0, d=d, window=128, min_size=128, seed=0)).specs
        out.update({f"fig6 {p} d={d} K=1": (s, 1) for p, s in fig6.items()})
    lm = build_specs(param_template(get_arch("qwen2-0.5b")), ZamplingConfig(
        compression=8, d=8, min_size=4096)).specs  # launch/train.py's
    out.update({f"qwen2-0.5b {p} K=4": (s, 4) for p, s in lm.items()})
    # tests/test_torch_gpu.py's FWD_SPECS[3] at its largest K
    out["gpu spec 3 K=33"] = (make_qspec(6, (48, 700), 48, compression=8,
                                         d=8, window=512, seed=2), 33)
    return out


GEOMETRY_CASES = _geometry_cases()


def _windows(spec):
    """The first, a full and the last window (ragged or empty)."""
    return sorted({0, max(0, spec.m // spec.rows_per_window - 1),
                   spec.num_windows - 1})


def _ctas(spec, geo, w):
    """The CTAs of window w that hold rows: (first row, rows) of each
    slice (a slice past the window's last row returns at once)."""
    r_win = w * spec.rows_per_window
    r_end = min(r_win + spec.rows_per_window, spec.m)
    for s in range(geo.slices):
        r_lo = r_win + s * geo.rows
        if r_lo < r_end:
            yield r_lo, min(geo.rows, r_end - r_lo)


def _sweeps(geo, K):
    """The body's sweeps: (first client, clients)."""
    for k0 in range(0, K, geo.clients):
        yield k0, min(geo.clients, K - k0)


def _staging(geo, window, kn):
    """Phase 1's loop over one sweep: how many times each (client,
    coordinate) is staged, (kn, window), and each thread's items."""
    took = np.zeros((kn, window), np.int64)
    words = -(-kn // 32)
    items = np.zeros(geo.threads, np.int64)
    for t in range(geo.threads):
        for q in range(t, words * window, geo.threads):
            c, wi = q % window, q // window
            took[32 * wi:min(32 * wi + 32, kn), c] += 1
            items[t] += 1
    return took, items


def _groups(geo, kn):
    """Phase 2's client groups of one sweep: (first client, word, shift,
    live clients)."""
    for kg in range(0, kn, geo.group):
        yield kg, kg >> 5, kg & 31, min(geo.group, kn - kg)


@pytest.mark.parametrize("name", list(GEOMETRY_CASES))
def test_forward_geometry_writes_each_row_and_client_once(name):
    spec, K = GEOMETRY_CASES[name]
    win, rpw = spec.window, spec.rows_per_window
    for values in (False, True):
        geo = reconstruct_geometry(win, rpw, spec.d, spec.num_windows, K,
                                   values)
        assert geo.threads == FWD_THREADS
        assert geo.ctas == spec.num_windows * geo.slices < 2**31
        assert geo.slices * geo.rows >= rpw > (geo.slices - 1) * geo.rows
        assert geo.rows >= min(rpw, FWD_ROWS_MIN)
        if geo.slices > 1:  # sliced only where windows are too few
            assert spec.num_windows * (geo.slices - 1) < FWD_TARGET_CTAS
        assert geo.group in FWD_GROUPS and 32 % geo.group == 0
        assert geo.group >= min(K, 32)
        assert 1 <= geo.clients <= K and geo.sweeps == -(-K // geo.clients)
        assert geo.words == -(-geo.clients // 32)
        assert geo.smem == 4 * fwd_words(spec.d, win, geo.clients, values)
        assert geo.smem <= SMEM_MAX
        staged = geo.smem // 4 - 2 * spec.d
        assert staged <= FWD_STAGE_WORDS or geo.clients <= max(
            geo.group, 32)
        for w in _windows(spec):
            r_win = w * rpw
            r_end = min(r_win + rpw, spec.m)
            written = np.zeros((max(r_end - r_win, 1), K), np.int64)
            for r_lo, nrows in _ctas(spec, geo, w):
                assert r_win <= r_lo < r_lo + nrows <= r_end
                for k0, kn in _sweeps(geo, K):
                    took, items = _staging(geo, win, kn)
                    assert (took == 1).all()  # once a CTA and sweep
                    assert items.max() <= -(-geo.words * win // geo.threads)
                    for kg, wi, sh, live in _groups(geo, kn):
                        assert wi < geo.words and sh + geo.group <= 32
                        # a thread a row, row fastest
                        for t in range(min(geo.threads, nrows)):
                            i = np.arange(t, nrows, geo.threads)
                            written[r_lo - r_win + i,
                                    k0 + kg:k0 + kg + live] += 1
            assert (written[:r_end - r_win] == 1).all()


# --- a numpy emulation of reconstruct_window -------------------------------

# (shape, fan_in, compression, d, window): a ragged last window (422
# rows a window, 419 in the last), Fig. 6's window at d=16 (128 rows a
# window), d=1 (where a row's one product decides its sign)
SMALL_SPECS = [((7, 301), 7, 8, 10, 64), ((24, 80), 24, 1, 16, 128),
               ((64, 48), 64, 4, 1, 64)]
KINDS = ["f32", "u8", "u16", "values", "masks"]
_QBITS = {"f32": None, "u8": 8, "u16": 16, "values": None, "masks": None}


def _small_spec(i):
    shape, fan_in, c, d, window = SMALL_SPECS[i]
    return make_qspec(4, shape, fan_in, compression=c, d=d, window=window,
                      seed=3)


def _operand(spec, K, kind, seed):
    """(K, n) operand with client 0 at 0 over window 1 (a p = 0 window),
    exact 0s and 1s, and (explicit operands) +-0 and negatives."""
    rng = np.random.RandomState(seed)
    win = slice(spec.window, 2 * spec.window) if spec.num_windows > 1 \
        else slice(0, spec.window)
    if kind == "masks":  # +0 and 1 only: the bits' path
        Z = (rng.rand(K, spec.n) < 0.5).astype(np.float32)
        Z[0, win] = 0.0
        return torch.from_numpy(Z)
    if kind == "values":
        Z = rng.randn(K, spec.n).astype(np.float32)
        Z[rng.rand(K, spec.n) < 0.4] = 0.0
        Z[rng.rand(K, spec.n) < 0.3] = -0.0
        Z[0, win] = -0.0
        if K > 1:
            Z[1, win] = 0.0
        return torch.from_numpy(Z)
    if kind == "f32":
        P = np.clip(rng.rand(K, spec.n) * 1.4 - 0.2, 0, 1).astype(np.float32)
        P[0, win] = 0.0
        return torch.from_numpy(P)
    top = 255 if kind == "u8" else 65535
    q = rng.randint(0, top + 1, (K, spec.n))
    q[rng.rand(K, spec.n) < 0.2] = 0
    q[rng.rand(K, spec.n) < 0.1] = top
    q[0, win] = 0
    return torch.from_numpy(q.astype(np.uint8 if kind == "u8"
                                     else np.uint16))


def _steps(K, seed):
    return as_words(np.random.RandomState(seed).randint(
        0, 2**32, K, dtype=np.uint64), "cpu")


def _draw_window(spec, P, steps, qbits, coords):
    """Phase 1's bits of a sweep's clients at a window's coordinates, as
    qz::mask_bit draws them: (kn, window) bool."""
    u = mask_u32(spec.seed, spec.tensor_id, steps[:, None],
                 torch.from_numpy(coords)[None, :])
    if qbits is None:
        return bernoulli_u32(u, P[:, coords]).numpy() > 0
    thr = quant_threshold_u24(word_values(P[:, coords]), qbits)
    return ((u >> 8) < thr).numpy()


def _batches(d):
    """Phase 2's batches of a row's edges: (first edge, edges), full
    batches of FWD_EDGE_ILP, then one edge at a time."""
    full = d // FWD_EDGE_ILP * FWD_EDGE_ILP
    return ([(j0, FWD_EDGE_ILP) for j0 in range(0, full, FWD_EDGE_ILP)]
            + [(j, 1) for j in range(full, d)])


def _signbit(x):
    return np.signbit(np.asarray(x, np.float32))


def _emulate(spec, geo, P, steps=None, qbits=None):
    """(W (K, m) f32, bits (K, n) bool, the phase-2 paths taken) as
    reconstruct_window computes them: per CTA and sweep the window's bit
    words, per group of G clients each row's edges summed from -0 in
    ascending j, in batches (a batch with no bit set skipped; the set
    clients' values added, or, with an explicit operand that is not all
    +0 and 1, every live client's products), then the sign rule where
    every product was +-0.
    ``steps`` None: P is the explicit operand (kernels 3 and 1)."""
    values = steps is None
    K, win, d, G = P.shape[0], spec.window, spec.d, geo.group
    W = np.full((K, spec.m), np.nan, np.float32)
    bits_all = np.zeros((K, spec.n), bool)
    paths = set()
    Zn = P.numpy() if values else None
    for w in range(spec.num_windows):
        coords = w * win + np.arange(win)
        for r_lo, nrows in _ctas(spec, geo, w):
            rows = torch.arange(r_lo, r_lo + nrows)
            idx = row_indices(spec, rows).numpy()  # in-window
            vals = row_values(spec, rows).numpy()
            for k0, kn in _sweeps(geo, K):
                # 1. a word of 32 clients' bits per coordinate
                if values:
                    z = Zn[k0:k0 + kn][:, coords]
                    bit = z != 0
                else:
                    bit = _draw_window(spec, P[k0:k0 + kn], steps[k0:k0 + kn],
                                       qbits, coords)
                bits_all[k0:k0 + kn, coords] = bit
                # the CTA's vote: an explicit operand of masks (+0 and 1
                # only) takes the drawn operand's path
                bits_path = not values or bool(
                    ((z.view(np.uint32) == 0) | (z == 1)).all())
                paths.add(bits_path)
                words = np.zeros((-(-kn // 32), win), np.uint64)
                for k in range(kn):
                    words[k // 32] |= bit[k].astype(np.uint64) << np.uint64(
                        k % 32)
                # 2. a thread a (row, group of G clients)
                for kg, wi, sh, live in _groups(geo, kn):
                    b = (words[wi][idx] >> np.uint64(sh)) & np.uint64(
                        (1 << G) - 1)  # (rows, d)
                    setb = ((b[..., None] >> np.arange(G, dtype=np.uint64))
                            & np.uint64(1)).astype(bool)[..., :live]
                    acc = np.full((nrows, live), -0.0, np.float32)
                    for j0, n_b in _batches(d):
                        # a batch with no bit set is skipped
                        on = setb[:, j0:j0 + n_b].any(axis=(1, 2))
                        for j in range(j0, j0 + n_b):
                            v = vals[:, j:j + 1]
                            if bits_path:  # the clients whose bit is set
                                add = setb[:, j]
                                prod = np.broadcast_to(v, acc.shape)
                            else:  # every live client's product
                                add = on[:, None] & np.ones(live, bool)
                                prod = v * z[kg:kg + live, idx[:, j]].T
                            acc = np.where(add, acc + prod, acc).astype(
                                np.float32)
                    need = acc == 0
                    for j in range(d):  # the sign rule
                        sv = _signbit(vals[:, j])[:, None]
                        if bits_path:
                            need &= sv
                        else:
                            sz = _signbit(z[kg:kg + live, idx[:, j]].T)
                            need &= sv != sz
                    out = np.where(need, np.float32(-0.0),
                                   np.where(acc == 0, np.float32(0.0), acc))
                    W[k0 + kg:k0 + kg + live, r_lo:r_lo + nrows] = out.T
    return W, bits_all, paths


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _variants(spec, K, values):
    """The geometry as built, and with a window's rows in three slices,
    sweeps of half the clients and groups of at most 4 (so groups sit
    at shifts inside their word)."""
    geo = reconstruct_geometry(spec.window, spec.rows_per_window, spec.d,
                               spec.num_windows, K, values)
    rows = -(-spec.rows_per_window // 3)
    small = geo._replace(slices=-(-spec.rows_per_window // rows), rows=rows,
                         clients=-(-K // 2), group=min(geo.group, 4))
    return geo, small


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("K", [1, 3, 10, 33])
@pytest.mark.parametrize("i", range(len(SMALL_SPECS)))
def test_emulation_equals_plain_bitwise(i, K, kind):
    spec = _small_spec(i)
    P = _operand(spec, K, kind, 31 * i + K)
    explicit = kind in ("values", "masks")
    if explicit:
        want = _bits(ops.reconstruct_plain(spec, P))
        steps = None
    else:
        steps = _steps(K, 7 * i + K)
        want = _bits(ops.sample_reconstruct_plain(spec, P, steps,
                                                  _QBITS[kind]))
    for geo in _variants(spec, K, explicit):
        got, _, paths = _emulate(spec, geo, P, steps, _QBITS[kind])
        assert np.array_equal(_bits(got), want)
        assert paths == {kind != "values"}
    # the sign rule was exercised: some sums are -0 and some +0
    zeros = want[(want & 0x7FFFFFFF) == 0]
    if spec.d == 1:
        assert (zeros == 0x80000000).any() and (zeros == 0).any()


def test_emulation_against_jax_interpret():
    """At a small spec with a ragged last window: the staged bits equal
    JAX's mask stream exactly, and the emulated forwards equal the
    Pallas batched forwards in interpret mode within tolerance."""
    shape, fan_in, c, d, window = SMALL_SPECS[0]
    spec = _small_spec(0)
    j = jq.make_qspec(4, shape, fan_in, compression=c, d=d, window=window,
                      seed=3)
    assert spec.m % spec.rows_per_window  # ragged
    K = 3
    P = _operand(spec, K, "f32", 5)
    words = np.random.RandomState(6).randint(0, 2**32, K, dtype=np.uint64
                                             ).astype(np.uint32)
    steps = as_words(words, "cpu")
    geo, _ = _variants(spec, K, False)
    got, bits, _ = _emulate(spec, geo, P, steps)
    jbits = np.asarray(js.sample_mask_hash(jnp.asarray(P.numpy()), j.seed,
                                           j.tensor_id, jnp.asarray(words)))
    assert np.array_equal(bits, jbits > 0)
    tol = spec.d * BOX_MULLER_ATOL * spec.sigma + 1e-7
    want = np.asarray(jpk.qz_sample_reconstruct_batched_fwd(
        j, jnp.asarray(P.numpy()), jnp.asarray(words)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    Z = torch.from_numpy(bits.astype(np.float32))
    geo, _ = _variants(spec, K, True)
    got3, _, paths = _emulate(spec, geo, Z)
    assert paths == {True}
    want3 = np.asarray(jpk.qz_reconstruct_batched_fwd(
        j, jnp.asarray(Z.numpy())))
    np.testing.assert_allclose(got3, want3, rtol=0, atol=tol)
    assert np.array_equal(_bits(got3), _bits(got))  # kernel 3 on 8's masks
