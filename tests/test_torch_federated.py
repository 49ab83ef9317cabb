"""The port's federated round against the JAX package, on the same inputs.

Small size: SMALL_DIMS (784-20-20-10), K=3 clients, E=2 local steps,
batch 8, compression 8, d=10, window 128, psum_u32 uplink, u8 downlink.
Inputs are seeded numpy arrays and explicit uint32 words; JAX runs on
the CPU under ``jax.jit``, as its fit loops run it.

Exact: the data arrays, draw words, the aggregated mean at every vote
count, the u8 words of a given aggregate, the encoded init state and
every metered byte count.  Allclose: losses, dense leaves and weights
(Box-Muller's log/cos differ between XLA and torch by up to 4.5e-5 on a
unit normal).  A round's upload bits can flip where a client's trained
probability lies within that rounding of its uniform draw: the share is
bounded, and every u8 word off a flipped coordinate is equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import metering as jmet, protocol as jprot
from repro.core import federated as jfed, sampling as js, zampling as jz
from repro.data import federated_split as jsplit, synthetic as jsyn
from repro.models import mlp as jmlp
from repro_torch import convert
from repro_torch.comm import bitpack as tbp, metering as tmet
from repro_torch.comm import protocol as tprot
from repro_torch.core import federated as tfed, sampling as ts
from repro_torch.core.zampling import (ZamplingConfig, build_specs,
                                       sample_weights)
from repro_torch.data import federated_split as tsplit, synthetic as tsyn
from repro_torch.models import mlp as tmlp
from repro_torch.train import evaluate, federated_fit

ZC = dict(compression=8, d=10, window=128, min_size=128, seed=1)
K, E, B = 3, 2, 8
FC = dict(num_clients=K, local_steps=E, local_lr=0.5, aggregate="psum_u32",
          downlink="u8")
LOSS_RTOL = 1e-4  # a loss sums many products of Box-Muller-rounded weights
DENSE_ATOL = 1e-5  # biases after E SGD steps at lr 0.5 on those losses
MAX_FLIP_SHARE = 1e-3  # upload bits flipped by rounding, of all bits


def _jtemplate(dims):
    return {f"layer{i}": {"kernel": jax.ShapeDtypeStruct((a, b), jnp.float32),
                          "bias": jax.ShapeDtypeStruct((b,), jnp.float32)}
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}


@pytest.fixture(scope="module")
def setup():
    zs = build_specs(tmlp.mlp_template(tmlp.SMALL_DIMS), ZamplingConfig(**ZC))
    jzs = jz.build_specs(_jtemplate(jmlp.SMALL_DIMS), jz.ZamplingConfig(**ZC))
    assert convert.zspecs_from_jax(jzs).specs == zs.specs
    rng = np.random.RandomState(0)
    scores = {p: rng.rand(s.n).astype(np.float32) for p, s in zs.specs.items()}
    dense = {p: (0.1 * rng.randn(*zs.template[p].shape)).astype(np.float32)
             for p in zs.dense_paths}
    ds = tsyn.make_teacher_dataset(n_train=240, n_test=60, seed=0)
    stream = tsplit.client_batch_stream(tsplit.iid_client_split(ds, K), B, E,
                                        seed=0)
    batches = [dict(zip(("x", "y"), next(stream))) for _ in range(2)]
    cfg, jcfg = tfed.FederatedConfig(**FC), jfed.FederatedConfig(**FC)
    st = tfed.encode_state(zs, cfg, {"scores": scores, "dense": dense}, 5,
                           device="cpu")
    jst = jfed.encode_state(jzs, jcfg, {
        "scores": {p: jnp.asarray(v) for p, v in scores.items()},
        "dense": {p: jnp.asarray(v) for p, v in dense.items()}}, 5)
    return dict(zs=zs, jzs=jzs, cfg=cfg, jcfg=jcfg, st=st, jst=jst, ds=ds,
                batches=batches)


def _np(x):
    return np.asarray(x)


def test_data_arrays_are_the_jax_packages():
    a = tsyn.make_teacher_dataset(n_train=300, n_test=50, seed=3)
    b = jsyn.make_teacher_dataset(n_train=300, n_test=50, seed=3)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    ta, tb = tsplit.iid_client_split(a, 4, seed=1), jsplit.iid_client_split(
        b, 4, seed=1)
    for ca, cb in zip(ta, tb):
        np.testing.assert_array_equal(ca.x_train, cb.x_train)
        np.testing.assert_array_equal(ca.y_train, cb.y_train)
    sa = tsplit.client_batch_stream(ta, 5, 3, seed=2)
    sb = jsplit.client_batch_stream(tb, 5, 3, seed=2)
    for _ in range(2):
        for xa, xb in zip(next(sa), next(sb)):
            np.testing.assert_array_equal(xa, xb)


@pytest.mark.parametrize("k", [3, 10])
def test_aggregated_mean_at_every_count_is_the_jitted_jax_mean(k):
    """The server mean of every vote count 0..K: XLA turns ``counts / K``
    into a multiply by 1/K under jit, and the port does the same."""
    n = 8 * (k + 1)
    counts = np.arange(n) % (k + 1)
    z = (np.arange(k)[:, None] < counts[None]).astype(np.float32)
    lanes = tbp.pack_mask(torch.from_numpy(z))
    jl = jnp.asarray(lanes.numpy().astype(np.uint32))
    want = _np(jax.jit(lambda l: jprot.get_transport(
        "psum_u32").aggregate_stacked_packed(l, n))(jl))
    got = tprot.get_transport("psum_u32").aggregate_stacked_packed(lanes, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tprot.get_transport("mean").aggregate_stacked(torch.from_numpy(z))
        .numpy(),
        _np(jax.jit(jprot.get_transport("mean_f32").aggregate_stacked)(z)))
    # the dense leaves' jnp.mean(axis=0): ascending sum, then * (1/K)
    d = np.random.RandomState(k).randn(k, 37).astype(np.float32)
    want_d = _np(jax.jit(lambda x: jnp.mean(x, axis=0))(d))
    np.testing.assert_array_equal(tprot.mean0(torch.from_numpy(d)).numpy(),
                                  want_d)
    np.testing.assert_array_equal(_np(jnp.mean(jnp.asarray(d), axis=0)),
                                  want_d)


def test_u8_words_of_an_aggregate_and_the_encoded_state(setup):
    zs, jzs, cfg, jcfg = setup["zs"], setup["jzs"], setup["cfg"], setup["jcfg"]
    for p in zs.specs:
        np.testing.assert_array_equal(setup["st"]["scores"][p].numpy(),
                                      _np(setup["jst"]["scores"][p]))
    rng = np.random.RandomState(4)
    agg = {p: (rng.randint(0, K + 1, s.n) / np.float32(K)).astype(np.float32)
           for p, s in zs.specs.items()}
    word, r = 99, 4
    want = jax.jit(lambda a: jfed._encode_scores(
        jzs, jcfg, a, np.uint32(word), r))(agg)
    got = tfed._encode_scores(zs, cfg, {p: torch.from_numpy(v)
                                        for p, v in agg.items()}, word, r)
    for p in zs.specs:
        np.testing.assert_array_equal(got[p].numpy(), _np(want[p]))
    dec = tfed.decode_state(zs, cfg, setup["st"], device="cpu")
    jdec = jfed.decode_state(jzs, jcfg, setup["jst"])
    for p in zs.specs:
        np.testing.assert_array_equal(dec["scores"][p].numpy(),
                                      _np(jdec["scores"][p]))


def test_metered_bytes_exact(setup):
    zs, jzs = setup["zs"], setup["jzs"]
    assert zs.dense_total == jzs.dense_total
    for agg in ("mean", "mean_f32", "psum_u32"):
        for down in ("f32", "u16", "u8"):
            want = jmet.round_wire_report(jzs, agg, 7, downlink=down)
            assert tmet.round_wire_report(zs, agg, 7, downlink=down) == want
    want = [r for r in jmet.wire_table(jzs, 10, downlink="u8")
            if r["strategy"] != "allgather_packed"]
    assert tmet.wire_table(zs, 10, downlink="u8") == want
    want = {r["codec"]: r for r in jmet.downlink_table(jzs, 10)}
    for row in tmet.downlink_table(zs, 10):
        assert row == want[row["codec"]]


def test_config_fields_and_what_raises():
    t = {f.name: f.default for f in dataclasses.fields(tfed.FederatedConfig)}
    j = {f.name: f.default for f in dataclasses.fields(jfed.FederatedConfig)}
    assert t == j
    tfed.FederatedConfig(mask_path="composed")  # ported: kernels 3 and 6
    for bad in (dict(mode="continuous"),
                dict(stream_chunk=4), dict(downlink_schedule="cosine"),
                dict(aggregate="allgather_packed"), dict(downlink="packed4")):
        with pytest.raises(NotImplementedError):
            tfed.FederatedConfig(**bad)
    for bad in (dict(mode="x"), dict(aggregate="x"), dict(downlink="x"),
                dict(min_clients=0)):
        with pytest.raises(ValueError):
            tfed.FederatedConfig(**bad)


def _jax_local(setup, words):
    jzs, jcfg, jst = setup["jzs"], setup["jcfg"], setup["jst"]
    b = setup["batches"][0]

    def one(batch, w):
        return jfed.local_update(jzs, jst, jmlp.mlp_loss, batch, w, jcfg)

    return jax.jit(jax.vmap(one))(
        {n: jnp.asarray(v) for n, v in b.items()},
        jnp.asarray(np.asarray(words, np.uint32)))


def test_local_update_per_client_gradients_and_draw_words(setup):
    """K clients in one batched step: each client's update must be its
    own loss's gradient (the sum, not the mean, of the K losses) and
    each draw at the JAX package's words."""
    zs, cfg, st = setup["zs"], setup["cfg"], setup["st"]
    kw, r = 1234, 6
    words = [ts.fold_word(kw, r, i) for i in range(K)]
    np.testing.assert_array_equal(
        np.asarray(words, np.uint32),
        _np(js.fold_word(np.uint32(kw), np.uint32(r),
                         jnp.arange(K, dtype=jnp.uint32))))
    b = {n: torch.from_numpy(v) for n, v in setup["batches"][0].items()}
    up, dense, loss = tfed.local_update(zs, st, tmlp.mlp_loss, b, words, cfg)
    jup, jdense, jloss = _jax_local(setup, words)
    np.testing.assert_allclose(loss.numpy(), _np(jloss), rtol=LOSS_RTOL)
    for p in zs.dense_paths:
        np.testing.assert_allclose(dense[p].numpy(), _np(jdense[p]), rtol=0,
                                   atol=DENSE_ATOL)
    flips = sum(int((tbp.unpack_mask(up[p], s.n) != tbp.unpack_mask(
        torch.from_numpy(_np(jup[p]).astype(np.int64)), s.n)).sum())
        for p, s in zs.specs.items())
    assert flips <= MAX_FLIP_SHARE * K * zs.n_total


def test_one_round_against_jax(setup):
    zs, jzs, cfg, jcfg = setup["zs"], setup["jzs"], setup["cfg"], setup["jcfg"]
    b = setup["batches"][0]
    key, r = 7, 2
    new, met = tfed.federated_round(zs, setup["st"], tmlp.mlp_loss, b, key,
                                    cfg, round_index=r, device="cpu")
    jnew, jmet_ = jax.jit(lambda s, bb: jfed.federated_round(
        jzs, s, jmlp.mlp_loss, bb, np.uint32(key), jcfg, round_index=r))(
        setup["jst"], {n: jnp.asarray(v) for n, v in b.items()})
    np.testing.assert_allclose(float(met["loss"]), float(jmet_["loss"]),
                               rtol=LOSS_RTOL)
    for name in tfed.WIRE_METRIC_KEYS:
        assert met[name] == float(jmet_[name])
    for p in zs.dense_paths:
        np.testing.assert_allclose(new["dense"][p].numpy(),
                                   _np(jnew["dense"][p]), rtol=0,
                                   atol=DENSE_ATOL)
    # a flipped upload bit moves one coordinate's count by one; every
    # other coordinate's u8 word (and decoded score) is exact
    differ = sum(int((new["scores"][p].numpy() != _np(jnew["scores"][p]))
                     .sum()) for p in zs.specs)
    assert differ <= MAX_FLIP_SHARE * K * zs.n_total
    dec = tfed.decode_state(zs, cfg, new, device="cpu")["scores"]
    jdec = jfed.decode_state(jzs, jcfg, jnew)["scores"]
    for p in zs.specs:
        same = new["scores"][p].numpy() == _np(jnew["scores"][p])
        np.testing.assert_array_equal(dec[p].numpy()[same],
                                      _np(jdec[p])[same])


def test_fit_equals_sequential_rounds_and_carries_u8(setup):
    zs, cfg, st = setup["zs"], setup["cfg"], setup["st"]
    bs = setup["batches"]
    words = [11, 12]
    state, mets = federated_fit(
        zs, st, tmlp.mlp_loss, {n: np.stack([b[n] for b in bs])
                                for n in ("x", "y")}, words, cfg,
        device="cpu")
    seq = st
    for r in range(2):
        seq, m = tfed.federated_round(zs, seq, tmlp.mlp_loss, bs[r],
                                      words[r], cfg, round_index=r,
                                      device="cpu")
        assert torch.equal(mets["loss"][r], m["loss"])
    for p in zs.specs:
        assert state["scores"][p].dtype == torch.uint8
        assert torch.equal(state["scores"][p], seq["scores"][p])
    for p in zs.dense_paths:
        assert torch.equal(state["dense"][p], seq["dense"][p])
    assert mets["uplink_bytes_per_client"].shape == (2,)


def test_f32_and_packed_transports_give_the_same_round(setup):
    """mean_f32 uploads f32 masks, psum_u32 packed lanes: the same bits
    and the same mean, so the same round."""
    zs, st, b = setup["zs"], setup["st"], setup["batches"][1]
    out = [tfed.federated_round(
        zs, st, tmlp.mlp_loss, b, 21,
        tfed.FederatedConfig(**{**FC, "aggregate": agg}), device="cpu")
        for agg in ("mean", "psum_u32")]
    (a, ma), (c, mc) = out
    assert ma["uplink_bytes_per_client"] > mc["uplink_bytes_per_client"]
    assert torch.equal(ma["loss"], mc["loss"])
    for p in zs.specs:
        assert torch.equal(a["scores"][p], c["scores"][p])


def test_sampled_networks_and_evaluate_off_the_u8_carry(setup):
    zs, jzs, ds = setup["zs"], setup["jzs"], setup["ds"]
    st, jst = setup["st"], setup["jst"]
    test = {"x": ds.x_test, "y": ds.y_test}
    tb = {n: torch.from_numpy(v) for n, v in test.items()}
    words = [3, 2**32 - 5]
    accs = []
    for w in words:
        params = sample_weights(zs, st, w, carried="u8", device="cpu")
        jparams = jz.sample_weights(jzs, jst, np.uint32(w), carried="u8")
        for p, spec in zs.specs.items():
            a, bb = p.split("/")
            np.testing.assert_allclose(
                params[p].numpy(), _np(jparams[a][bb]), rtol=0,
                atol=spec.d * 4.5e-5 * spec.sigma)
        accs.append(float(jmlp.mlp_accuracy(jparams, test)))
    mean, std = evaluate(zs, st, lambda prm: tmlp.mlp_accuracy(prm, tb),
                         words, carried="u8", device="cpu")
    # a prediction may flip where two logits tie within the rounding
    assert abs(mean - np.mean(accs)) <= 1.0 / len(ds.y_test)


def test_convert_a_jax_round_state(setup):
    zs, st = convert.federated_state_from_jax(setup["jzs"], setup["jst"],
                                              device="cpu")
    for p in zs.specs:
        assert torch.equal(st["scores"][p], setup["st"]["scores"][p])
    for p in zs.dense_paths:
        assert torch.equal(st["dense"][p], setup["st"]["dense"][p])
