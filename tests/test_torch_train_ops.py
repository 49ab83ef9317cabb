"""The port's training ops against the JAX package, on the same inputs.

Inputs are seeded numpy arrays and explicit uint32 draw words (never
``jax.random``).  JAX runs on the CPU through its plain reference
(``impl="ref"``) and, for the Pallas kernels the port replaces (6, 7, 8
and 10), in interpret mode.

Exact: the clip's gradient, row-plan indices, transpose-plan rows, deg
and counts, mask bits, upload lanes, vote counts.  Allclose: Q values
and everything summed from them, because Box-Muller's log/cos differ
between XLA and torch by up to 4.5e-5 on a unit normal (scaled by
sigma here), plus summation-order rounding (the Pallas backward sums
in its own block order).  Bitwise inside the port: the K=1 forward
equals the batched forward's row; the u8 forward equals the f32
forward on the decoded scores.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import bitpack as jbp, downlink as jdl
from repro.core import qspec as jq, reconstruct as jrec, sampling as js
from repro.core import transpose_plan as jtp
from repro.kernels import ops as jops, qz_reconstruct as jpk
from repro_torch.comm import bitpack as tbp, downlink as tdl
from repro_torch.core import qspec as tq, reconstruct as trec
from repro_torch.core import sampling as ts, transpose_plan as ttp
from repro_torch.kernels import ops as tops

BOX_MULLER_ATOL = 4.5e-5  # on unit normals, XLA vs torch log/cos
# relative rounding allowance for sums taken in another order
SUM_RTOL = 1e-5

# (shape, fan_in, window): multi-window with a ragged last window, a
# single window, and a tail of padding rows (m_pad > m)
SPECS = [((96, 80), 96, 128), ((40, 24), 40, 32), ((7, 300), 7, 64)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run beside other test processes,
    and torch's thread pools would only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(i, tid=3):
    shape, fan_in, window = SPECS[i]
    kw = dict(compression=8, d=10, window=window, seed=1)
    t = tq.make_qspec(tid, shape, fan_in, **kw)
    j = jq.make_qspec(tid, shape, fan_in, **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    return t, j


def _words(k, seed):
    return np.random.RandomState(seed).randint(0, 2**32, k, dtype=np.uint64
                                               ).astype(np.uint32)


def _probs(k, n, seed):
    # a share of exact 0s and 1s, as decoded broadcasts carry
    p = np.random.RandomState(seed).rand(k, n).astype(np.float32) * 1.4 - 0.2
    return np.clip(p, 0.0, 1.0).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    """|got - want| <= tol elementwise (tol broadcasts, may be an array)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) - tol
    assert got.shape == want.shape and (err <= 0).all(), (
        f"{(err > 0).sum()} of {err.size} entries beyond tolerance, worst "
        f"by {err.max():.3e}")


def _w_tol(spec):
    """A row sums <= d values, each off by <= 4.5e-5 sigma."""
    return spec.d * BOX_MULLER_ATOL * spec.sigma + 1e-7


def _grad_tol(spec, G):
    """Per coordinate: 4.5e-5 sigma per incoming edge times |g|, plus
    rounding of a sum taken in another order."""
    q = trec.materialize_q(spec)
    g = torch.as_tensor(np.abs(G), dtype=torch.float32).reshape(len(G), -1)
    return (BOX_MULLER_ATOL * spec.sigma * (g @ (q != 0).to(torch.float32))
            + SUM_RTOL * (g @ q.abs()) + 1e-7).numpy()


def test_clip_probs_gradient_matches_jax_at_the_boundaries():
    s = np.array([-0.5, 0.0, 0.5, 1.0, 1.5], np.float32)
    want = np.asarray(jax.grad(lambda x: js.clip_probs(x).sum())(
        jnp.asarray(s)))
    x = _t(s).requires_grad_(True)
    ts.clip_probs(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), want)
    np.testing.assert_array_equal(want, [0.0, 0.5, 1.0, 0.5, 0.0])


def test_fold_word_and_mask_streams_exact():
    for words in [(7, 2, 0), (2**32 - 1, 5), (123456789, 0, 9, 100)]:
        assert ts.fold_word(*words) == int(js.fold_word(*words))
    p = _probs(3, 200, 0)
    steps = _words(3, 1)
    jz = js.sample_mask_hash(jnp.asarray(p), 1, 4, jnp.asarray(steps))
    tz = ts.sample_mask_hash(_t(p), 1, 4, ts.as_words(steps, "cpu"))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    # straight-through: forward the draw, backward the identity
    x = _t(p).requires_grad_(True)
    zst = ts.sample_mask_st_hash(x, 1, 4, ts.as_words(steps, "cpu"))
    assert torch.equal(zst.detach(), tz)
    zst.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    q = jdl.get_codec("u8").encode(jq.make_qspec(4, (40, 40), 40), p[0], 5)
    jzq = js.sample_mask_qhash(q, 8, 1, 4, steps[0])
    tzq = ts.sample_mask_qhash(_t(np.asarray(q)), 8, 1, 4, int(steps[0]))
    np.testing.assert_array_equal(tzq.numpy(), np.asarray(jzq))


@pytest.mark.parametrize("n", [1, 31, 32, 200])
def test_bitpack_and_vote_counts_exact(n):
    z = (np.random.RandomState(n).rand(5, n) < 0.4).astype(np.float32)
    jl = np.asarray(jbp.pack_mask(jnp.asarray(z)))
    tl = tbp.pack_mask(_t(z))
    assert tbp.packed_len(n) == jbp.packed_len(n) == tl.shape[-1]
    np.testing.assert_array_equal(tl.numpy(), jl.astype(np.int64))
    np.testing.assert_array_equal(tbp.unpack_mask(tl, n).numpy(), z)
    np.testing.assert_array_equal(
        tbp.packed_popcount_sum(tl, n).numpy(),
        np.asarray(jbp.packed_popcount_sum(jnp.asarray(jl), n)))


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_row_plan_and_transpose_plan(i):
    t, j = _specs(i)
    jg, jv = jtp.row_plan(j)
    tg, tv = ttp.row_plan(t)
    np.testing.assert_array_equal(tg.numpy(), jg)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0,
                               atol=BOX_MULLER_ATOL * t.sigma)
    jp = jtp.build_transpose_plan(j)
    tp = ttp.build_transpose_plan(t)
    assert tp.deg == jp.deg and tp.n_edges == jp.n_edges == t.m * t.d
    np.testing.assert_array_equal(tp.rows.numpy(), jp.rows)
    np.testing.assert_array_equal(tp.counts.numpy(), jp.counts)
    np.testing.assert_allclose(tp.vals.numpy(), jp.vals, rtol=0,
                               atol=BOX_MULLER_ATOL * t.sigma)
    # the values are placed by gather: exactly the row plan's value of
    # the edge (source row r, the slot k whose coordinate is c)
    row0 = torch.arange(t.num_windows)[:, None, None] * t.rows_per_window
    rows = (tp.rows.to(torch.int64) + row0).reshape(t.n, tp.deg)
    vals = tp.vals.reshape(t.n, tp.deg)
    live = torch.arange(tp.deg)[None] < tp.counts[:, None]
    c_ids = torch.arange(t.n)[:, None].expand(t.n, tp.deg)[live]
    r_ids = rows[live]
    k = (tg[r_ids] == c_ids[:, None]).to(torch.int64).argmax(1)
    assert torch.equal(vals[live], tv[r_ids, k])
    assert not vals[~live].any() and not tp.rows.reshape(t.n, -1)[~live].any()


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_reconstruct_and_transpose_against_materialized_q(i):
    t, j = _specs(i)
    rng = np.random.RandomState(i)
    Z = (rng.rand(3, t.n) < 0.5).astype(np.float32)
    G = rng.randn(3, *t.shape).astype(np.float32)
    q = trec.materialize_q(t).numpy()
    np.testing.assert_allclose(q, np.asarray(jrec.materialize_q(j)), rtol=0,
                               atol=BOX_MULLER_ATOL * t.sigma)
    W = trec.reconstruct_batched_ref(t, _t(Z)).numpy()
    np.testing.assert_allclose(W.reshape(3, -1), Z @ q.T, rtol=SUM_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(
        W, np.asarray(jrec.reconstruct_batched_ref(j, jnp.asarray(Z))),
        rtol=0, atol=_w_tol(t))
    gz = trec.grad_z_plan_batched_ref(t, _t(G)).numpy()
    np.testing.assert_allclose(gz, G.reshape(3, -1) @ q, rtol=SUM_RTOL,
                               atol=1e-6)
    _close(gz, jrec.grad_z_plan_batched_ref(j, jnp.asarray(G)),
           _grad_tol(t, G))
    # the single-client forms are the batched rows
    assert torch.equal(trec.reconstruct_ref(t, _t(Z[1])),
                       trec.reconstruct_batched_ref(t, _t(Z))[1])
    assert torch.equal(trec.grad_z_plan_ref(t, _t(G[2])),
                       trec.grad_z_plan_batched_ref(t, _t(G))[2])
    # padding helpers invert each other
    flat = trec._move_batched(t, _t(G))
    back = trec._select_valid_batched(t, trec._insert_padding_batched(t, flat))
    assert torch.equal(back, flat)
    assert torch.equal(trec._unmove_batched(t, flat), _t(G))
    one = trec._move(t, _t(G[0]))
    assert torch.equal(trec._select_valid(t, trec._insert_padding(t, one)),
                       one)
    assert torch.equal(trec._unmove(t, one), _t(G[0]))


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("i", range(len(SPECS)))
def test_sample_reconstruct_batched_forward_and_gradient(i, impl):
    """Kernels 8 and 6 (plain versions) against JAX's fused op and
    ``jax.grad`` of it, on the reference and in Pallas interpret mode."""
    t, j = _specs(i)
    rng = np.random.RandomState(10 + i)
    S = rng.rand(3, t.n).astype(np.float32) * 1.4 - 0.2
    steps = _words(3, i)
    R = rng.randn(3, *t.shape).astype(np.float32)

    def jloss(s):
        W = jops.sample_reconstruct_batched(j, js.clip_probs(s),
                                            jnp.asarray(steps), impl=impl)
        return jnp.sum(W * R), W

    (_, jW), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(S))
    x = _t(S).requires_grad_(True)
    W = tops.sample_reconstruct_batched(t, ts.clip_probs(x), steps,
                                        impl="ref")
    (W * _t(R)).sum().backward()
    np.testing.assert_allclose(W.detach().numpy(), np.asarray(jW), rtol=0,
                               atol=_w_tol(t))
    _close(x.grad.numpy(), jg, _grad_tol(t, R))
    # exact zeros where the clip is flat, half where it ties
    flat = (S < 0) | (S > 1)
    assert not x.grad.numpy()[flat].any()


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_plain_kernels_against_pallas_interpret(i):
    """Kernels 6, 7, 8 and 10 in JAX's interpret mode against the
    port's plain versions of its CUDA kernels."""
    t, j = _specs(i)
    assert j.window % 32 == 0  # the Pallas pack takes whole lanes
    rng = np.random.RandomState(20 + i)
    P = _probs(3, t.n, 30 + i)
    steps = _words(3, 40 + i)
    G = rng.randn(3, t.m).astype(np.float32)
    w = ts.as_words(steps, "cpu")
    # 8: batched sample-reconstruct
    np.testing.assert_allclose(
        tops.sample_reconstruct_plain(t, _t(P), w).numpy(),
        np.asarray(jpk.qz_sample_reconstruct_batched_fwd(
            j, jnp.asarray(P), jnp.asarray(steps))), rtol=0, atol=_w_tol(t))
    # 7: one client off u8 words
    q = np.asarray(jdl.get_codec("u8").encode(j, P[0], 11))
    np.testing.assert_allclose(
        tops.sample_reconstruct_plain(t, _t(q[None]), w[:1], 8)[0].numpy(),
        np.asarray(jpk.qz_sample_reconstruct_fwd(
            j, jnp.asarray(q), jnp.asarray(steps[0]), qbits=8)),
        rtol=0, atol=_w_tol(t))
    # 6: plan backward (the Pallas kernel sums in its own block order)
    _close(tops.plan_bwd_plain(t, _t(G)).numpy(),
           jpk.qz_reconstruct_batched_bwd_plan(j, jnp.asarray(G)),
           _grad_tol(t, G))
    # 10: upload lanes, exact
    np.testing.assert_array_equal(
        tops.sample_pack_plain(t, _t(P), w).numpy(),
        np.asarray(jpk.qz_sample_pack_batched_fwd(
            j, jnp.asarray(P), jnp.asarray(steps))).astype(np.int64))


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_upload_lanes_exact(i):
    t, j = _specs(i)
    P = _probs(4, t.n, 50 + i)
    steps = _words(4, 60 + i)
    want = np.asarray(jops.sample_pack_batched(
        j, jnp.asarray(P), jnp.asarray(steps), impl="ref")).astype(np.int64)
    got = tops.sample_pack_batched(t, _t(P), steps)
    np.testing.assert_array_equal(got.numpy(), want)
    one = tops.sample_pack(t, _t(P[2]), int(steps[2]))
    np.testing.assert_array_equal(one.numpy(), want[2])


def test_window_below_32_takes_the_plain_pack(monkeypatch):
    """window % 32 != 0: sample_pack runs the plain path even when the
    kernels are asked for, as the JAX package's does."""
    t = tq.make_qspec(2, (6, 10), 6, compression=8, d=4, window=16)
    assert t.window % 32
    P = _probs(2, t.n, 3)
    from repro_torch.kernels import qz_reconstruct

    def boom(*a, **k):
        raise AssertionError("the kernel was called")

    monkeypatch.setattr(qz_reconstruct, "qz_sample_pack_batched_fwd", boom)
    monkeypatch.setattr(tops, "resolve_impl", lambda impl, x: "cuda")
    got = tops.sample_pack_batched(t, _t(P), [5, 6])
    want = tbp.pack_mask(ts.sample_mask_hash(_t(P), t.seed, t.tensor_id,
                                             ts.as_words([5, 6], "cpu")))
    assert torch.equal(got, want)


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_single_client_forward_equals_the_batched_row(i):
    t, _ = _specs(i)
    P = _t(_probs(3, t.n, 70 + i))
    steps = _words(3, 80 + i)
    W = tops.sample_reconstruct_batched(t, P, steps)
    for k in range(3):
        assert torch.equal(tops.sample_reconstruct(t, P[k], int(steps[k])),
                           W[k])


@pytest.mark.parametrize("codec", ["u8", "u16"])
def test_word_forward_equals_f32_forward_on_decoded_scores(codec):
    t, _ = _specs(0)
    c = tdl.get_codec(codec)
    q = c.encode(t, _t(_probs(1, t.n, 5)[0]), 9)
    for step in (3, 2**31 + 7):
        a = tops.sample_reconstruct(t, q, step, qbits=c.bits)
        b = tops.sample_reconstruct(t, c.decode(t, q), step)
        assert torch.equal(a, b)


def test_plain_forward_equals_composed_reconstruction():
    t, _ = _specs(2)
    P = _t(_probs(3, t.n, 1))
    w = ts.as_words(_words(3, 2), "cpu")
    Z = ts.sample_mask_hash(P, t.seed, t.tensor_id, w)
    fused = trec._unmove_batched(t, tops.sample_reconstruct_plain(t, P, w))
    assert torch.equal(fused, trec.reconstruct_batched_ref(t, Z))


def test_dispatch_and_bwd_path_gate(monkeypatch):
    t, _ = _specs(1)
    P = _t(_probs(2, t.n, 0))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.sample_reconstruct_batched(t, P, [1, 2], impl="cuda")
    with pytest.raises(ValueError, match="unknown reconstruction impl"):
        tops.sample_reconstruct_batched(t, P, [1, 2], impl="pallas")
    monkeypatch.setenv("REPRO_RECONSTRUCT_IMPL", "cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.sample_pack_batched(t, P, [1, 2])
    monkeypatch.delenv("REPRO_RECONSTRUCT_IMPL")
    grads = {}
    for path, want in (("plan", ("plan", "canonical")),
                       ("plan:canonical", ("plan", "canonical")),
                       ("plan:slot", ("plan", "slot")),
                       ("scatter", ("scatter", None))):
        monkeypatch.setenv("REPRO_BWD_PLAN", path)
        assert ttp.resolve_bwd_path() == want
        x = P.clone().requires_grad_(True)
        W = tops.sample_reconstruct_batched(t, x, [1, 2])
        W.sum().backward()  # the gate is read when the backward runs
        grads[path] = x.grad
    # the scatter sums each coordinate in the canonical plan's order
    assert torch.equal(grads["scatter"], grads["plan"])
    assert torch.equal(grads["plan:canonical"], grads["plan"])
    assert torch.allclose(grads["plan:slot"], grads["plan"], rtol=1e-5,
                          atol=1e-6)
    monkeypatch.setenv("REPRO_BWD_PLAN", "bogus")
    with pytest.raises(ValueError, match="REPRO_BWD_PLAN|unknown bwd path"):
        ttp.resolve_bwd_path()
    # the draw word gets no gradient; a word operand takes none either
    q = tdl.get_codec("u8").encode(t, P[0], 1)
    assert not tops.sample_reconstruct(t, q, 4, qbits=8).requires_grad
