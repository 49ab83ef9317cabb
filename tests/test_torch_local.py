"""The port's local-zampling path against the JAX package, on the same
inputs.

Small size: SMALL_DIMS (784-20-20-10) at compression 4, d=5, window
128, plus one spec at d=50.  Inputs are seeded numpy arrays and explicit
uint32 draw words (never ``jax.random``); JAX runs on the CPU through
its plain reference (``impl="ref"``) and, for the Pallas kernels the
port replaces here (1, 3 and 5), in interpret mode.

Exact: the discretized mask, drawn and discretized masks, the Adam
step count.  Allclose, with the tolerance stated at each check: Q
values and everything summed from them (Box-Muller's log/cos differ
between XLA and torch by up to 4.5e-5 on a unit normal), optimizer
arithmetic (``b ** t`` and the divisions may round differently by an
ulp).  Bitwise inside the port: fused equals composed, forward and
gradient, single and batched, as ``tests/test_fused.py`` pins for JAX;
the K=1 forms equal the batched rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import federated as jfed, qspec as jq, sampling as js
from repro.core import zampling as jz
from repro.kernels import ops as jops, qz_reconstruct as jpk
from repro.models import mlp as jmlp
from repro.optim import optimizers as jopt
from repro.train import local as jlocal
from repro_torch import convert
from repro_torch.core import federated as tfed, qspec as tq
from repro_torch.core import sampling as ts
from repro_torch.core.zampling import (MaskProgram, ZamplingConfig,
                                       build_specs, init_state,
                                       sample_masks, sample_weights)
from repro_torch.data import federated_split as tsplit, synthetic as tsyn
from repro_torch.kernels import ops as tops
from repro_torch.models import mlp as tmlp
from repro_torch.optim import optimizers as topt
from repro_torch.train import (LocalTrainConfig, evaluate,
                               train_local_zampling, train_step)

BOX_MULLER_ATOL = 4.5e-5  # on unit normals, XLA vs torch log/cos
SUM_RTOL = 1e-5  # rounding of a sum taken in another order
OPT_RTOL = 1e-6  # f32 optimizer arithmetic, an ulp or two apart
LOSS_RTOL = 1e-4  # a loss sums many products of Box-Muller-rounded weights
# an Adam step at lr 1e-2 from equal moments: gradients that part by
# Box-Muller rounding move a score by an ulp or two (6e-8 measured)
SCORE_ATOL = 1e-6
ZC = dict(compression=4, d=5, window=128, min_size=128, seed=0)

# (shape, fan_in, window, d): SMALL_DIMS' layer0 at compression 4 (31
# windows), and a spec at d=50 with a ragged last window
SPECS = [((784, 20), 784, 128, 5), ((96, 80), 96, 128, 50)]


def _specs(i, tid=2):
    shape, fan_in, window, d = SPECS[i]
    kw = dict(compression=4, d=d, window=window, seed=0)
    t = tq.make_qspec(tid, shape, fan_in, **kw)
    j = jq.make_qspec(tid, shape, fan_in, **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    return t, j


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


def _probs(k, n, seed):
    p = np.random.RandomState(seed).rand(k, n).astype(np.float32) * 1.4 - 0.2
    return np.clip(p, 0.0, 1.0).astype(np.float32)


def _close(got, want, tol):
    """|got - want| <= tol elementwise (tol broadcasts, may be an array)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) - tol
    assert got.shape == want.shape and (err <= 0).all(), (
        f"{(err > 0).sum()} of {err.size} entries beyond tolerance, worst "
        f"by {err.max():.3e}")


def _w_tol(spec, zmax=1.0):
    """A row sums d values times operands in [0, zmax], each value off
    by <= 4.5e-5 sigma."""
    return spec.d * BOX_MULLER_ATOL * spec.sigma * zmax + 1e-6


def _grad_tol(spec, G):
    """Per coordinate: 4.5e-5 sigma per incoming edge times |g|, plus
    rounding of a sum taken in another order."""
    from repro_torch.core.reconstruct import materialize_q

    q = materialize_q(spec)
    g = torch.as_tensor(np.abs(G), dtype=torch.float32).reshape(len(G), -1)
    return (BOX_MULLER_ATOL * spec.sigma * (g @ (q != 0).to(torch.float32))
            + SUM_RTOL * (g @ q.abs()) + 1e-7).numpy()


def _jtemplate(dims):
    return {f"layer{i}": {"kernel": jax.ShapeDtypeStruct((a, b), jnp.float32),
                          "bias": jax.ShapeDtypeStruct((b,), jnp.float32)}
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}


def _jflat(tree):
    """JAX params {"layer0": {"kernel": ...}} -> {"layer0/kernel": ...}."""
    return {f"{a}/{b}": v for a, sub in tree.items() for b, v in sub.items()}


@pytest.fixture(scope="module")
def small():
    zs = build_specs(tmlp.mlp_template(tmlp.SMALL_DIMS), ZamplingConfig(**ZC))
    jzs = jz.build_specs(_jtemplate(jmlp.SMALL_DIMS), jz.ZamplingConfig(**ZC))
    assert convert.zspecs_from_jax(jzs).specs == zs.specs
    rng = np.random.RandomState(0)
    scores = {p: (rng.rand(s.n) * 1.4 - 0.2).astype(np.float32)
              for p, s in zs.specs.items()}
    dense = {p: (0.1 * rng.randn(*zs.template[p].shape)).astype(np.float32)
             for p in zs.dense_paths}
    ds = tsyn.make_teacher_dataset(n_train=256, n_test=200, seed=0)
    return dict(zs=zs, jzs=jzs, scores=scores, dense=dense, ds=ds,
                st=init_state(zs, scores, dense, device="cpu"),
                jst={"scores": {p: jnp.asarray(v) for p, v in scores.items()},
                     "dense": {p: jnp.asarray(v) for p, v in dense.items()}})


# ---------------------------------------------------------------------------
# optimizers and masks
# ---------------------------------------------------------------------------

def _opt_pair(name):
    if name == "adam":
        return topt.adam(1e-2), jopt.adam(1e-2)
    if name == "clip":
        return topt.clip_by_global_norm(0.5), jopt.clip_by_global_norm(0.5)
    return (topt.chain(topt.clip_by_global_norm(0.5), topt.adam(1e-2)),
            jopt.chain(jopt.clip_by_global_norm(0.5), jopt.adam(1e-2)))


@pytest.mark.parametrize("name", ["adam", "clip", "chain"])
def test_optimizers_against_jax(name):
    """Three updates on the same grads: updates, moments and the step
    count agree (rtol OPT_RTOL: ``b ** t`` and the divisions may round an
    ulp apart between XLA and torch)."""
    rng = np.random.RandomState(1)
    params = {"a": rng.randn(7, 3).astype(np.float32),
              "b": rng.randn(11).astype(np.float32)}
    topt_, jopt_ = _opt_pair(name)
    ts_, js_ = topt_.init({k: _t(v) for k, v in params.items()}), \
        jopt_.init(params)
    tp = {k: _t(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    for step in range(3):
        grads = {k: (rng.randn(*v.shape) * 3).astype(np.float32)
                 for k, v in params.items()}
        tu, ts_ = topt_.update({k: _t(v) for k, v in grads.items()}, ts_, tp)
        ju, js_ = jopt_.update({k: jnp.asarray(v) for k, v in grads.items()},
                               js_, jp)
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), _np(ju[k]),
                                       rtol=OPT_RTOL, atol=1e-7)
        tp = topt.apply_updates(tp, tu)
        jp = jopt.apply_updates(jp, ju)
        for k in params:
            assert tp[k].dtype == torch.float32
            np.testing.assert_allclose(tp[k].numpy(), _np(jp[k]),
                                       rtol=OPT_RTOL, atol=1e-7)
    adam_t = ts_ if name == "adam" else (ts_[1] if name == "chain" else None)
    adam_j = js_ if name == "adam" else (js_[1] if name == "chain" else None)
    if adam_t is not None:
        assert int(adam_t.step) == int(adam_j.step) == 3
        assert adam_t.step.dtype == torch.int32
        for k in params:
            np.testing.assert_allclose(adam_t.mu[k].numpy(),
                                       _np(adam_j.mu[k]), rtol=OPT_RTOL)
            np.testing.assert_allclose(adam_t.nu[k].numpy(),
                                       _np(adam_j.nu[k]), rtol=OPT_RTOL)


def test_discretize_mask_exact():
    p = np.array([0.0, 0.2, 0.49999997, 0.5, 0.50000006, 1.0], np.float32)
    p = np.concatenate([p, _probs(1, 300, 3)[0]])
    want = _np(js.discretize_mask(jnp.asarray(p)))
    got = ts.discretize_mask(_t(p))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[:6], [0, 0, 0, 1, 1, 1])


# ---------------------------------------------------------------------------
# kernels 1, 3 and 5: the reconstruct ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("i", range(len(SPECS)))
def test_reconstruct_forward_and_gradient_against_jax(i, impl):
    """``ops.reconstruct``/``_batched`` (plain versions of kernels 1 and
    3 forward, 5 and 6 backward) against JAX's ops and ``jax.grad`` on
    continuous operands in [0, 1]."""
    t, j = _specs(i)
    rng = np.random.RandomState(10 + i)
    Z = _probs(3, t.n, 20 + i)
    R = rng.randn(3, *t.shape).astype(np.float32)

    def jloss_b(z):
        W = jops.reconstruct_batched(j, z, impl=impl)
        return jnp.sum(W * R), W

    def jloss_1(z):
        w = jops.reconstruct(j, z, impl=impl)
        return jnp.sum(w * R[1]), w

    (_, jW), jg = jax.value_and_grad(jloss_b, has_aux=True)(jnp.asarray(Z))
    (_, jw), jg1 = jax.value_and_grad(jloss_1, has_aux=True)(
        jnp.asarray(Z[1]))
    x = _t(Z).requires_grad_(True)
    W = tops.reconstruct_batched(t, x, impl="ref")
    (W * _t(R)).sum().backward()
    x1 = _t(Z[1]).requires_grad_(True)
    w = tops.reconstruct(t, x1, impl="ref")
    (w * _t(R[1])).sum().backward()
    np.testing.assert_allclose(W.detach().numpy(), _np(jW), rtol=0,
                               atol=_w_tol(t))
    np.testing.assert_allclose(w.detach().numpy(), _np(jw), rtol=0,
                               atol=_w_tol(t))
    _close(x.grad.numpy(), jg, _grad_tol(t, R))
    _close(x1.grad.numpy(), jg1, _grad_tol(t, R[1:2])[0])
    # the single-client op is the batched op's row, forward and gradient
    assert torch.equal(w, W[1])
    assert torch.equal(x1.grad, x.grad[1])


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_plain_kernels_against_pallas_interpret(i):
    """Kernels 1, 3 and 5 in JAX's interpret mode against the port's
    plain versions of its CUDA kernels (moved flat order = natural order
    at major_axis 0)."""
    t, j = _specs(i)
    rng = np.random.RandomState(30 + i)
    Z = _probs(3, t.n, 40 + i)
    g = rng.randn(t.m).astype(np.float32)
    np.testing.assert_allclose(
        tops.reconstruct_plain(t, _t(Z)).numpy(),
        _np(jpk.qz_reconstruct_batched_fwd(j, jnp.asarray(Z))), rtol=0,
        atol=_w_tol(t))
    np.testing.assert_allclose(
        tops.reconstruct_plain(t, _t(Z[2:]))[0].numpy(),
        _np(jpk.qz_reconstruct_fwd(j, jnp.asarray(Z[2]))), rtol=0,
        atol=_w_tol(t))
    # the Pallas backward sums in its own block order
    _close(tops.plan_bwd_one_plain(t, _t(g)).numpy(),
           jpk.qz_reconstruct_bwd_plan(j, jnp.asarray(g)),
           _grad_tol(t, g[None])[0])
    assert torch.equal(tops.plan_bwd_one_plain(t, _t(g)),
                       tops.plan_bwd_plain(t, _t(g[None]))[0])


def test_reconstruct_dispatch_and_shapes():
    t, _ = _specs(0)
    z = _t(_probs(1, t.n, 0)[0])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.reconstruct(t, z, impl="cuda")
    with pytest.raises(ValueError, match="spec expects"):
        tops.reconstruct(t, z[None])
    with pytest.raises(ValueError, match="spec expects"):
        tops.reconstruct_batched(t, z)
    # a CPU tensor runs the plain path through the kernel wrappers too
    from repro_torch.kernels import qz_reconstruct as qr

    g = _t(np.random.RandomState(2).randn(t.m).astype(np.float32))
    assert torch.equal(qr.qz_reconstruct_fwd(t, z),
                       tops.reconstruct_plain(t, z[None])[0])
    assert torch.equal(qr.qz_reconstruct_bwd_plan(t, g),
                       tops.plan_bwd_one_plain(t, g))


# ---------------------------------------------------------------------------
# the mask program: modes, composed path, sampled networks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,fused", [("sample", False),
                                        ("continuous", True),
                                        ("discretize", True)])
def test_mask_program_weights_against_jax(small, mode, fused):
    zs, jzs, st, jst = small["zs"], small["jzs"], small["st"], small["jst"]
    word = 2**32 - 9
    got = MaskProgram(zs, mode=mode, fused=fused).weights(
        st["scores"], st["dense"], word)
    want = _jflat(jz.MaskProgram(jzs, mode=mode, fused=fused).weights(
        jst["scores"], jst["dense"], np.uint32(word)))
    for p, spec in zs.specs.items():
        np.testing.assert_allclose(got[p].detach().numpy(), _np(want[p]),
                                   rtol=0, atol=_w_tol(spec))
    for p in zs.dense_paths:
        np.testing.assert_array_equal(got[p].numpy(), _np(want[p]))
    # the masks themselves are exact
    tm = sample_masks(zs, st, word, mode=mode, device="cpu")
    jm = jz.sample_masks(jzs, jst, np.uint32(word), mode=mode)
    for p in zs.specs:
        np.testing.assert_array_equal(tm[p].detach().numpy(), _np(jm[p]))


@pytest.mark.parametrize("batched", [False, True])
def test_fused_equals_composed_forward_and_gradient(small, batched):
    """Inside the port, exact equality of the fused sample-mode op and
    the composed path (straight-through mask, then reconstruct), forward
    and gradient."""
    zs, st = small["zs"], small["st"]
    K = 4
    out = []
    for fused in (True, False):
        if batched:
            scores = {p: v.expand(K, -1).clone().requires_grad_(True)
                      for p, v in st["scores"].items()}
            dense = {p: v.expand(K, *v.shape) for p, v in st["dense"].items()}
            step = torch.tensor([3, 7, 2**31, 2**32 - 1])
        else:
            scores = {p: v.clone().requires_grad_(True)
                      for p, v in st["scores"].items()}
            dense, step = st["dense"], 11
        prm = MaskProgram(zs, fused=fused).weights(scores, dense, step)
        loss = sum((prm[p] * torch.cos(torch.arange(
            prm[p].numel(), dtype=torch.float32)).reshape(prm[p].shape)).sum()
                   for p in zs.specs)
        grads = torch.autograd.grad(loss, [scores[p] for p in zs.specs])
        out.append(([prm[p].detach() for p in zs.specs], grads))
    (wf, gf), (wc, gc) = out
    for a, b in zip(wf, wc):
        assert torch.equal(a, b)
    for a, b in zip(gf, gc):
        assert torch.equal(a, b)
    # the clip's flat region takes no gradient on either path
    for p, g in zip(zs.specs, gc):
        s = scores[p].detach()
        assert not g[(s < 0) | (s > 1)].any()


def test_mask_program_validates_mode(small):
    with pytest.raises(ValueError, match="unknown mask mode"):
        MaskProgram(small["zs"], mode="bogus")
    # the continuous upload is the clipped probabilities themselves
    up = MaskProgram(small["zs"], mode="continuous").upload(
        small["st"]["scores"], 1)
    for p, s in small["st"]["scores"].items():
        assert torch.equal(up[p], torch.clamp(s, 0.0, 1.0))


@pytest.mark.parametrize("mode", ["continuous", "discretize"])
def test_evaluate_expected_and_discretized_against_jax(small, mode):
    zs, jzs, st, jst, ds = (small[k] for k in ("zs", "jzs", "st", "jst",
                                              "ds"))
    test = {"x": ds.x_test, "y": ds.y_test}
    tb = {n: torch.from_numpy(v) for n, v in test.items()}
    got, gstd = evaluate(zs, st, lambda prm: tmlp.mlp_accuracy(prm, tb),
                         mode=mode, device="cpu")
    want, wstd = jlocal.evaluate(
        jzs, jst, lambda prm: jmlp.mlp_accuracy(prm, test), np.uint32(0),
        mode=mode)
    assert gstd == wstd == 0.0
    # a prediction may flip where two logits tie within the rounding
    assert abs(got - want) <= 1.0 / len(ds.y_test)
    # off a u8 carry: the mode's mask of the decoded probabilities
    cfg = tfed.FederatedConfig(downlink="u8")
    enc = tfed.encode_state(zs, cfg, st, 3, device="cpu")
    jenc = jfed.encode_state(jzs, jfed.FederatedConfig(downlink="u8"), jst,
                             3)
    for p in zs.specs:
        np.testing.assert_array_equal(enc["scores"][p].numpy(),
                                      _np(jenc["scores"][p]))
    got8, _ = evaluate(zs, enc, lambda prm: tmlp.mlp_accuracy(prm, tb),
                       mode=mode, carried="u8", device="cpu")
    want8, _ = jlocal.evaluate(
        jzs, jenc, lambda prm: jmlp.mlp_accuracy(prm, test), np.uint32(0),
        mode=mode, carried="u8")
    assert abs(got8 - want8) <= 1.0 / len(ds.y_test)
    # the discretized network off u8 words equals it off decoded scores
    dec = tfed.decode_state(zs, cfg, enc, device="cpu")
    a = sample_weights(zs, enc, 0, mode=mode, carried="u8", device="cpu")
    b = sample_weights(zs, dec, 0, mode=mode, device="cpu")
    for p in zs.specs:
        assert torch.equal(a[p], b[p])


# ---------------------------------------------------------------------------
# the composed federated round
# ---------------------------------------------------------------------------

FC = dict(num_clients=3, local_steps=2, local_lr=0.5, aggregate="psum_u32",
          downlink="u8", mask_path="composed")
DENSE_ATOL = 1e-5  # biases after E SGD steps at lr 0.5 on those losses
MAX_FLIP_SHARE = 1e-3  # upload bits flipped by Box-Muller rounding


def test_composed_round_against_jax_and_the_fused_round(small):
    zs, jzs, st, jst, ds = (small[k] for k in ("zs", "jzs", "st", "jst",
                                              "ds"))
    stream = tsplit.client_batch_stream(tsplit.iid_client_split(ds, 3), 8, 2,
                                        seed=0)
    b = dict(zip(("x", "y"), next(stream)))
    cfg, jcfg = tfed.FederatedConfig(**FC), jfed.FederatedConfig(**FC)
    st8 = tfed.encode_state(zs, cfg, st, 5, device="cpu")
    jst8 = jfed.encode_state(jzs, jcfg, jst, 5)
    key, r = 7, 1
    new, met = tfed.federated_round(zs, st8, tmlp.mlp_loss, b, key, cfg,
                                    round_index=r, device="cpu")
    jnew, jmet = jax.jit(lambda s, bb: jfed.federated_round(
        jzs, s, jmlp.mlp_loss, bb, np.uint32(key), jcfg, round_index=r))(
        jst8, {n: jnp.asarray(v) for n, v in b.items()})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    for p in zs.dense_paths:
        np.testing.assert_allclose(new["dense"][p].numpy(),
                                   _np(jnew["dense"][p]), rtol=0,
                                   atol=DENSE_ATOL)
    differ = sum(int((new["scores"][p].numpy() != _np(jnew["scores"][p]))
                     .sum()) for p in zs.specs)
    assert differ <= MAX_FLIP_SHARE * 3 * zs.n_total
    # the fused round gives the same state and loss bit for bit
    fused, fmet = tfed.federated_round(
        zs, st8, tmlp.mlp_loss, b, key,
        tfed.FederatedConfig(**{**FC, "mask_path": "fused"}), round_index=r,
        device="cpu")
    assert torch.equal(fmet["loss"], met["loss"])
    for p in zs.specs:
        assert torch.equal(fused["scores"][p], new["scores"][p])
    for p in zs.dense_paths:
        assert torch.equal(fused["dense"][p], new["dense"][p])


# ---------------------------------------------------------------------------
# local training: state, conversion, early stopping
# ---------------------------------------------------------------------------

def test_init_state_checks_and_fills(small):
    zs, scores = small["zs"], small["scores"]
    st = init_state(zs, scores, device="cpu")
    for p in zs.dense_paths:
        assert torch.equal(st["dense"][p], torch.zeros(
            zs.template[p].shape))
    nested = {"layer1": {"bias": np.full(20, 3.0, np.float32)}}
    st = init_state(zs, scores, nested, device="cpu")
    assert torch.equal(st["dense"]["layer1/bias"], torch.full((20,), 3.0))
    bad = dict(scores, **{"layer1/kernel": scores["layer1/kernel"][:-1]})
    with pytest.raises(ValueError, match="spec expects"):
        init_state(zs, bad, device="cpu")


def _jax_adam_steps(small, steps, words, batches):
    jzs, jst = small["jzs"], small["jst"]
    opt = jopt.adam(1e-2)

    @jax.jit
    def step(state, opt_state, batch, word):
        def loss(tr):
            return jmlp.mlp_loss(jz.sample_weights(jzs, tr, word), batch)

        l, grads = jax.value_and_grad(loss)(state)
        updates, opt_state = opt.update(grads, opt_state, state)
        return jopt.apply_updates(state, updates), opt_state, l

    state, opt_state = jst, opt.init(jst)
    for t in range(steps):
        state, opt_state, _ = step(state, opt_state, batches[t],
                                   np.uint32(words[t]))
    return state, opt_state, step


def test_local_state_from_jax_and_one_more_step(small):
    """A JAX local state and its AdamState after two steps carry across
    exactly; one more step from them agrees (scores within SCORE_ATOL)."""
    zs, ds = small["zs"], small["ds"]
    it = ds.batches(16, seed=1)
    batches = [dict(zip(("x", "y"), next(it))) for _ in range(3)]
    words = [5, 6, 7]
    jstate, jopt_state, jstep = _jax_adam_steps(small, 2, words, batches)
    tzs, st, ost = convert.local_state_from_jax(small["jzs"], jstate,
                                                jopt_state, device="cpu")
    assert tzs.specs == zs.specs
    for part in ("scores", "dense"):
        for p, v in st[part].items():
            np.testing.assert_array_equal(v.numpy(), _np(jstate[part][p]))
            np.testing.assert_array_equal(ost.mu[p].numpy(),
                                          _np(jopt_state.mu[part][p]))
            np.testing.assert_array_equal(ost.nu[p].numpy(),
                                          _np(jopt_state.nu[part][p]))
    assert int(ost.step) == 2 and ost.step.dtype == torch.int32
    b = {n: torch.from_numpy(v) for n, v in batches[2].items()}
    new, ost2, loss, _ = train_step(zs, st, ost, b, words[2], tmlp.mlp_loss,
                                    topt.adam(1e-2))
    jnew, jost2, jloss = jstep(jstate, jopt_state,
                               {n: jnp.asarray(v) for n, v in
                                batches[2].items()}, np.uint32(words[2]))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert int(ost2.step) == int(jost2.step) == 3
    # the same masks (same scores, same word) and moments: the updated
    # scores part by the Box-Muller rounding of the gradients only
    for p in zs.specs:
        _close(new["scores"][p].numpy(), jnew["scores"][p], SCORE_ATOL)
    without = convert.local_state_from_jax(small["jzs"], jstate,
                                           device="cpu")
    assert without[2] is None


def test_train_local_zampling_continuous_and_early_stopping(small):
    """Continuous mode draws nothing (no words); a flat eval metric
    stops the run after ``patience`` evaluations without a gain."""
    zs, st, ds = small["zs"], small["st"], small["ds"]
    cfg = LocalTrainConfig(steps=50, lr=1e-2, mode="continuous",
                           eval_every=2, patience=2)
    batches = ({"x": x, "y": y} for x, y in ds.batches(16, seed=0))
    evals = []

    def flat_metric(params):
        evals.append(1)
        return 0.5

    state, hist = train_local_zampling(zs, st, tmlp.mlp_loss, batches, cfg,
                                       None, eval_fn=flat_metric,
                                       device="cpu")
    # evaluations at steps 2, 4, 6: the first sets the best, two more
    # without a gain stop the run
    assert len(hist["loss"]) == 6 and hist["eval"] == [0.5] * 3
    assert all(np.isfinite(hist["loss"]))
    for p in zs.specs:
        assert not torch.equal(state["scores"][p], st["scores"][p])
    with pytest.raises(ValueError, match="one word per step"):
        train_local_zampling(zs, st, tmlp.mlp_loss, batches,
                             LocalTrainConfig(steps=3), [1, 2],
                             device="cpu")


def test_local_train_config_fields_are_the_jax_packages():
    t = {f.name: f.default for f in dataclasses.fields(LocalTrainConfig)}
    j = {f.name: f.default for f in dataclasses.fields(
        jlocal.LocalTrainConfig)}
    assert t == j
    # the port draws at explicit words, so a seed it would ignore raises
    with pytest.raises(ValueError, match="draw word"):
        LocalTrainConfig(seed=5)
