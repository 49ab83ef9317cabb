"""The port's federated wire against the JAX package: the packed
downlink codecs, the ``allgather_packed`` transport, the metering, and
the ``continuous`` and ``discretize`` rounds.

Small size, as ``test_torch_federated.py``: SMALL_DIMS (784-20-20-10),
K=3 clients, E=2 local steps, batch 8, compression 8, d=10, window 128;
the metering also at Fig. 4's MNISTFC 784-300-100-10.  Inputs are seeded
numpy arrays and explicit uint32 words; JAX runs on the CPU under
``jax.jit`` (its rounds) or in interpret mode (its Pallas kernels 7 and
8 on packed lanes).

Exact: packed lanes and words, dithers, thresholds, encoded and decoded
codecs, the stacked means of every transport, masks drawn off lanes,
continuous and discretize uploads, every metered byte.  Allclose, at
``test_one_round_against_jax``'s tolerances: a round's loss, dense
leaves and (continuous mode) scores; a round's packed or u8 words may
differ where an upload bit flipped by Box-Muller rounding, within
MAX_FLIP_SHARE.  Weights at ``test_torch_train_ops.py``'s tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import bitpack as jbp, downlink as jdl
from repro.comm import metering as jmet, protocol as jprot
from repro.core import federated as jfed, qspec as jq, zampling as jz
from repro.kernels import ops as jops, qz_reconstruct as jpk
from repro.models import mlp as jmlp
from repro_torch import convert
from repro_torch.comm import bitpack as tbp, downlink as tdl
from repro_torch.comm import metering as tmet, protocol as tprot
from repro_torch.core import federated as tfed, qspec as tq
from repro_torch.core.zampling import (MaskProgram, ZamplingConfig,
                                       build_specs, sample_weights)
from repro_torch.data import federated_split as tsplit, synthetic as tsyn
from repro_torch.kernels import ops as tops
from repro_torch.models import mlp as tmlp
from repro_torch.train import evaluate, federated_fit
from test_torch_federated import (B, DENSE_ATOL, E, FC, K, LOSS_RTOL,
                                  MAX_FLIP_SHARE, ZC, _jtemplate)

BOX_MULLER_ATOL = 4.5e-5  # on unit normals, XLA vs torch log/cos
WIDTHS = (1, 2, 3, 4, 6, 8, 16)
FIG4_ZC = dict(compression=8, d=10, window=128, min_size=128, seed=1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run beside other test processes,
    and torch's thread pools would only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _lanes(t):
    """A port packed carry as the uint32 array the JAX carry holds."""
    assert t.dtype == torch.uint32
    return t.numpy()


def _specs(tid=3, shape=(96, 80), fan_in=96, window=128):
    kw = dict(compression=8, d=10, window=window, seed=1)
    return (tq.make_qspec(tid, shape, fan_in, **kw),
            jq.make_qspec(tid, shape, fan_in, **kw))


@pytest.fixture(scope="module")
def wire():
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
    return dict(zs=zs, jzs=jzs, scores=scores, dense=dense, ds=ds,
                batches=batches)


def _states(wire, **fc):
    """(port cfg, JAX cfg, port state, JAX state), both encoded at word 5
    from the same f32 scores."""
    cfg = tfed.FederatedConfig(**{**FC, **fc})
    jcfg = jfed.FederatedConfig(**{**FC, **fc})
    st = tfed.encode_state(wire["zs"], cfg, {"scores": wire["scores"],
                                             "dense": wire["dense"]}, 5,
                           device="cpu")
    jst = jfed.encode_state(wire["jzs"], jcfg, {
        "scores": {p: jnp.asarray(v) for p, v in wire["scores"].items()},
        "dense": {p: jnp.asarray(v) for p, v in wire["dense"].items()}}, 5)
    return cfg, jcfg, st, jst


# ---------------------------------------------------------------------------
# lanes, codecs, transports, metering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", WIDTHS)
def test_word_lanes_and_packed_codec_exact(bits):
    """pack_words/unpack_words at ragged n, and the packed codec's
    encode (lanes), words, thresholds, decode and metered bits."""
    assert tbp.words_per_lane(bits) == jbp.words_per_lane(bits)
    rng = np.random.RandomState(bits)
    for n in (1, 33, 257):
        q = rng.randint(0, 1 << bits, (3, n)).astype(np.uint32)
        assert tbp.packed_word_len(n, bits) == jbp.packed_word_len(n, bits)
        lanes = tbp.pack_words(_t(q.astype(np.int64)), bits)
        np.testing.assert_array_equal(
            _lanes(lanes), _np(jbp.pack_words(jnp.asarray(q), bits)))
        np.testing.assert_array_equal(
            tbp.unpack_words(lanes, n, bits).numpy(), q.astype(np.int64))
    t, j = _specs(window=128 if bits != 3 else 64)
    tc, jc = tdl.packed_codec(bits), jdl.packed_codec(bits)
    assert (tc.name, tc.bits, tc.packed, tc.wire_len(t.n)) == (
        jc.name, jc.bits, jc.packed, jc.wire_len(j.n))
    assert tc.downlink_bits_per_client(t.n) == jc.downlink_bits_per_client(
        j.n)
    s = (rng.rand(t.n) * 1.4 - 0.2).astype(np.float32)
    s[:4] = [0.0, 1.0, 0.5, 1.0 / 255]
    for word in (7, 2**32 - 1):
        jw = _np(jc.encode(j, jnp.asarray(s), np.uint32(word)))
        tw = tc.encode(t, _t(s), word)
        np.testing.assert_array_equal(_lanes(tw), jw)
        words = tc.wire_words(t, tw)
        np.testing.assert_array_equal(
            words.numpy(), _np(jc.wire_words(j, jnp.asarray(jw))))
        np.testing.assert_array_equal(
            tc.threshold_u24(words).numpy(),
            _np(jc.threshold_u24(jc.wire_words(j, jnp.asarray(jw)))))
        np.testing.assert_array_equal(
            tc.decode(t, tw).numpy(), _np(jc.decode(j, jnp.asarray(jw))))


def test_codec_registry_and_routing():
    for name in ("packed4", "packed2", "u4", "u2", "u8", "u16", "f32"):
        tc, jc = tdl.get_codec(name), jdl.get_codec(name)
        assert (tc.name, tc.bits, tc.quantized, tc.packed) == (
            jc.name, jc.bits, jc.quantized, jc.packed)
    assert tdl.get_codec("u4") is tdl.get_codec("packed4")
    assert tdl.packed_codec(4) is tdl.get_codec("packed4")
    # the JAX registry may hold more widths, registered by other tests
    assert set(tdl.codec_names()) <= set(jdl.codec_names())
    assert set(tdl.codec_names(include_aliases=False)) >= {
        "f32", "u16", "u8", "packed4", "packed2"}
    for dtype in (torch.float32, torch.bfloat16):
        assert tdl.codec_for_dtype(dtype).name == "f32"
    assert tdl.codec_for_dtype(torch.uint8).name == "u8"
    for mod, dtype in ((tdl, torch.uint32), (jdl, jnp.uint32)):
        with pytest.raises(ValueError, match="ambiguous"):
            mod.codec_for_dtype(dtype)
    for bad in (0, 17):
        with pytest.raises(ValueError):
            tdl.packed_codec(bad)


@pytest.mark.parametrize("k", [3, 10])
def test_allgather_packed_stacked_mean_is_psum_u32s(k):
    """The stacked popcount mean of (K, L) lanes: JAX's, and psum_u32's
    and mean_f32's of the same bits, bit for bit (K=10 holds count 9,
    where 1/K and a true division part)."""
    n = 300
    rng = np.random.RandomState(k)
    z = (rng.rand(k, n) < 0.5).astype(np.float32)
    z[:, :k + 1] = np.tril(np.ones((k + 1, k)), -1).T  # every count 0..K
    lanes = tbp.pack_mask(_t(z))
    ag = tprot.get_transport("allgather_packed")
    got = ag.aggregate_stacked_packed(lanes, n)
    assert got.dtype == torch.float32
    want = jax.jit(lambda L: jprot.get_transport(
        "allgather_packed").aggregate_stacked_packed(L, n))(
        jnp.asarray(lanes.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    for other in (tprot.get_transport("psum_u32").aggregate_stacked_packed(
                      lanes, n),
                  tprot.get_transport("mean_f32").aggregate_stacked(_t(z)),
                  ag.aggregate_stacked(_t(z))):
        assert torch.equal(got, other)
    assert ag.packed_wire and ag.uplink_bits_per_client(n) == 32 * 10
    assert tprot.transport_names() == jprot.transport_names()


def test_wire_reports_at_fig4_exact():
    """round_wire_report, wire_table and downlink_table at Fig. 4's
    MNISTFC (784-300-100-10, compression 8, d=10, window 128) equal
    JAX's; the packed codecs' metered bytes are the realized lanes."""
    dims = tmlp.MNISTFC_DIMS
    zs = build_specs(tmlp.mlp_template(dims), ZamplingConfig(**FIG4_ZC))
    jzs = jz.build_specs(_jtemplate(dims), jz.ZamplingConfig(**FIG4_ZC))
    assert zs.n_total == 33_408
    for agg in ("mean", "mean_f32", "psum_u32", "allgather_packed"):
        for down in ("f32", "u16", "u8", "packed4", "packed2", "u4", "u2"):
            for mode in ("sample", "continuous", "discretize"):
                assert tmet.round_wire_report(
                    zs, agg, 10, mode=mode, downlink=down) == \
                    jmet.round_wire_report(jzs, agg, 10, mode=mode,
                                           downlink=down)
    assert tmet.wire_table(zs, 10, downlink="packed4") == jmet.wire_table(
        jzs, 10, downlink="packed4")
    want = {r["codec"]: r for r in jmet.downlink_table(
        jzs, 10, aggregate="allgather_packed")}
    rows = tmet.downlink_table(zs, 10, aggregate="allgather_packed")
    assert {r["codec"] for r in rows} >= {"packed4", "packed2"}
    for row in rows:
        assert row == want[row["codec"]]
    rep = {d: tmet.round_wire_report(zs, "allgather_packed", 10, downlink=d)
           for d in ("packed4", "packed2", "u8", "f32")}
    assert [rep[d]["downlink_bytes_per_client"]
            for d in ("packed4", "packed2", "u8", "f32")] == [
        18_344.0, 9_992.0, 35_048.0, 135_272.0]
    assert rep["packed4"]["uplink_bytes_per_client"] == 5_816.0
    dense = 4 * zs.dense_total
    assert dense == 1_640
    assert (rep["packed4"]["downlink_bytes_per_client"] - dense) * 8 == \
        4 * zs.n_total
    assert (rep["packed2"]["downlink_bytes_per_client"] - dense) * 16 == \
        4 * zs.n_total


# ---------------------------------------------------------------------------
# masks, kernels and uploads off the wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["packed4", "packed2"])
@pytest.mark.parametrize("mode", ["sample", "continuous", "discretize"])
def test_masks_from_wire_off_lanes_exact(wire, codec, mode):
    zs, jzs = wire["zs"], wire["jzs"]
    _, _, st, jst = _states(wire, downlink=codec)
    program = MaskProgram(zs, mode=mode, downlink=codec)
    jprogram = jz.MaskProgram(jzs, mode=mode, downlink=codec)
    for word in (2**32 - 5,):
        got = program.masks_from_wire(st["scores"], word)
        for p, spec in zs.specs.items():
            np.testing.assert_array_equal(_lanes(st["scores"][p]),
                                          _np(jst["scores"][p]))
            want = jprogram.mask_from_wire(jst["scores"][p], jzs.specs[p],
                                           np.uint32(word))
            np.testing.assert_array_equal(got[p].detach().numpy(),
                                          _np(want))


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_plain_kernels_7_and_8_on_lanes_against_jax(bits):
    """The plain versions of kernels 7 and 8 on packed lanes: JAX's Pallas
    kernels in interpret mode where a window holds whole lanes (b = 2,
    4), JAX's reference path at b = 3 (128 % 10 != 0, which JAX sends to
    it); the masks drawn off the lanes exactly."""
    t, j = _specs(window=128)
    rng = np.random.RandomState(bits)
    codec = tdl.packed_codec(bits)
    P = np.clip(rng.rand(3, t.n) * 1.4 - 0.2, 0, 1).astype(np.float32)
    lanes = torch.stack([codec.encode(t, _t(P[k]), 9 + k) for k in range(3)])
    jl = jnp.asarray(_lanes(lanes))
    steps = rng.randint(0, 2**32, 3, dtype=np.uint64).astype(np.uint32)
    w = torch.as_tensor(steps.astype(np.int64))
    tol = t.d * BOX_MULLER_ATOL * t.sigma + 1e-7
    W = tops.sample_reconstruct_plain(t, lanes, w, bits, qpacked=True)
    if bits == 3:
        want8 = jax.vmap(lambda L, s: jops._sample_one(
            j, L, s, bits, True))(jl, jnp.asarray(steps))
        Z = tops._draw(t, lanes, w, bits, qpacked=True)
        np.testing.assert_array_equal(Z.numpy(), _np(want8))
        want = _np(jops.sample_reconstruct_batched(
            j, jl, jnp.asarray(steps), qbits=bits, qpacked=True,
            impl="ref")).reshape(3, -1)
        np.testing.assert_allclose(
            tops.sample_reconstruct_batched(t, lanes, w, qbits=bits,
                                            qpacked=True).reshape(3, -1),
            want, rtol=0, atol=tol)
        return
    np.testing.assert_allclose(
        W.numpy(), _np(jpk.qz_sample_reconstruct_batched_fwd(
            j, jl, jnp.asarray(steps), qbits=bits, qpacked=True)),
        rtol=0, atol=tol)
    np.testing.assert_allclose(
        tops.sample_reconstruct_plain(t, lanes[:1], w[:1], bits,
                                      qpacked=True)[0].numpy(),
        _np(jpk.qz_sample_reconstruct_fwd(j, jl[0], jnp.asarray(steps[0]),
                                          qbits=bits, qpacked=True)),
        rtol=0, atol=tol)


def test_lanes_forward_equals_words_and_decoded_forwards():
    """Inside the port, bitwise: kernel 8's plain version off lanes
    equals it off the unpacked words as per-coordinate words, and the
    one-client op equals the batched row; the operand is checked."""
    t, _ = _specs()
    codec = tdl.get_codec("packed4")
    rng = np.random.RandomState(1)
    lanes = torch.stack([codec.encode(t, _t(rng.rand(t.n).astype(
        np.float32)), k) for k in range(3)])
    w = torch.tensor([5, 6, 7])
    W = tops.sample_reconstruct_batched(t, lanes, w, qbits=4, qpacked=True)
    dec = codec.decode(t, lanes)
    assert torch.equal(W, tops.sample_reconstruct_batched(t, dec, w).detach())
    assert torch.equal(W[1], tops.sample_reconstruct(t, lanes[1], 6, qbits=4,
                                                     qpacked=True))
    with pytest.raises(ValueError, match="requires qbits"):
        tops.sample_reconstruct(t, lanes[0], 1, qpacked=True)
    with pytest.raises(ValueError, match="spec expects"):
        tops.sample_reconstruct_batched(t, lanes[:, 1:], w, qbits=4,
                                        qpacked=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.sample_reconstruct(t, lanes[0], 1, qbits=4, qpacked=True,
                                impl="cuda")


@pytest.mark.parametrize("mode,packed", [("continuous", False),
                                         ("discretize", True),
                                         ("discretize", False)])
def test_continuous_and_discretize_uploads_exact(wire, mode, packed):
    zs, jzs = wire["zs"], wire["jzs"]
    rng = np.random.RandomState(2)
    s = {p: (rng.rand(v.n) * 1.4 - 0.2).astype(np.float32)
         for p, v in zs.specs.items()}
    s[next(iter(s))][:3] = [0.5, np.nextafter(0.5, 0), 1.0]
    got = MaskProgram(zs, mode=mode, packed=packed).upload(
        {p: _t(v) for p, v in s.items()}, 4)
    want = jz.MaskProgram(jzs, mode=mode, packed=packed).upload(
        {p: jnp.asarray(v) for p, v in s.items()}, np.uint32(4))
    for p in zs.specs:
        np.testing.assert_array_equal(
            got[p].numpy(), _np(want[p]).astype(got[p].numpy().dtype))
        if mode == "continuous":
            assert got[p].dtype == torch.float32
            np.testing.assert_array_equal(got[p].numpy(),
                                          np.clip(s[p], 0, 1))


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------

def _words_of(codec, zs, scores):
    c = tdl.get_codec(codec)
    if not c.quantized:
        return None
    return {p: c.wire_words(spec, scores[p]) if c.packed else scores[p]
            for p, spec in zs.specs.items()}


@pytest.mark.parametrize("agg,down,mode", [
    ("allgather_packed", "packed4", "sample"),
    ("psum_u32", "u8", "discretize"),
    ("mean_f32", "f32", "continuous")])
def test_one_round_against_jax(wire, agg, down, mode):
    zs, jzs = wire["zs"], wire["jzs"]
    cfg, jcfg, st, jst = _states(wire, aggregate=agg, downlink=down,
                                 mode=mode)
    b = wire["batches"][0]
    key, r = 7, 2
    new, met = tfed.federated_round(zs, st, tmlp.mlp_loss, b, key, cfg,
                                    round_index=r, device="cpu")
    jnew, jmet_ = jax.jit(lambda s, bb: jfed.federated_round(
        jzs, s, jmlp.mlp_loss, bb, np.uint32(key), jcfg, round_index=r))(
        jst, {n: jnp.asarray(v) for n, v in b.items()})
    np.testing.assert_allclose(float(met["loss"]), float(jmet_["loss"]),
                               rtol=LOSS_RTOL)
    for name in tfed.WIRE_METRIC_KEYS:
        assert met[name] == float(jmet_[name])
    for p in zs.dense_paths:
        np.testing.assert_allclose(new["dense"][p].numpy(),
                                   _np(jnew["dense"][p]), rtol=0,
                                   atol=DENSE_ATOL)
    codec = tdl.get_codec(down)
    if codec.quantized:
        jwords = {p: _np(jdl.get_codec(down).wire_words(
            jzs.specs[p], jnew["scores"][p])) for p in zs.specs}
        words = _words_of(down, zs, new["scores"])
        differ = sum(int((words[p].to(torch.int64).numpy()
                          != jwords[p].astype(np.int64)).sum())
                     for p in zs.specs)
        assert differ <= MAX_FLIP_SHARE * K * zs.n_total
        for p, spec in zs.specs.items():
            assert new["scores"][p].dtype == codec.wire_dtype
            assert new["scores"][p].shape == (codec.wire_len(spec.n),)
    else:  # continuous: the mean of K trained probabilities, f32
        for p in zs.specs:
            np.testing.assert_allclose(new["scores"][p].numpy(),
                                       _np(jnew["scores"][p]), rtol=0,
                                       atol=DENSE_ATOL)
    if mode == "discretize":  # a rounded mask takes no gradient
        up, _, _ = tfed.local_update(zs, st, tmlp.mlp_loss, {
            n: _t(v) for n, v in b.items()}, [1, 2, 3], cfg)
        dec = tfed.decode_state(zs, cfg, st, device="cpu")["scores"]
        for p, spec in zs.specs.items():
            want = tbp.pack_mask((dec[p] >= 0.5).to(torch.float32))
            assert torch.equal(up[p], want.expand(K, -1))


def test_transports_give_the_same_packed_round(wire):
    """mean_f32, psum_u32 and allgather_packed: one round with the same
    packed4 lanes and loss; only the metered uplink differs."""
    out = {}
    for agg in ("mean_f32", "psum_u32", "allgather_packed"):
        cfg, _, st, _ = _states(wire, aggregate=agg, downlink="packed4")
        out[agg] = tfed.federated_round(wire["zs"], st, tmlp.mlp_loss,
                                        wire["batches"][1], 21, cfg,
                                        device="cpu")
    (a, ma), (b, mb), (c, mc) = out.values()
    assert ma["uplink_bytes_per_client"] > mb["uplink_bytes_per_client"] \
        == mc["uplink_bytes_per_client"]
    assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(
        mb["loss"], mc["loss"])
    for p in wire["zs"].specs:
        np.testing.assert_array_equal(_lanes(a["scores"][p]),
                                      _lanes(c["scores"][p]))
        np.testing.assert_array_equal(_lanes(b["scores"][p]),
                                      _lanes(c["scores"][p]))


def test_fit_carries_packed_lanes_and_evaluates_off_them(wire):
    zs, ds = wire["zs"], wire["ds"]
    cfg, _, st, _ = _states(wire, aggregate="allgather_packed",
                            downlink="packed2")
    bs = wire["batches"]
    state, mets = federated_fit(
        zs, st, tmlp.mlp_loss, {n: np.stack([b[n] for b in bs])
                                for n in ("x", "y")}, [11, 12], cfg,
        device="cpu")
    seq = st
    for r in range(2):
        seq, m = tfed.federated_round(zs, seq, tmlp.mlp_loss, bs[r],
                                      [11, 12][r], cfg, round_index=r,
                                      device="cpu")
        assert torch.equal(mets["loss"][r], m["loss"])
    for p, spec in zs.specs.items():
        assert state["scores"][p].dtype == torch.uint32
        assert state["scores"][p].shape == (tbp.packed_word_len(spec.n, 2),)
        np.testing.assert_array_equal(_lanes(state["scores"][p]),
                                      _lanes(seq["scores"][p]))
    # a sampled network off the lanes is the one off the decoded scores
    dec = tfed.decode_state(zs, cfg, state, device="cpu")
    for w in (3, 2**32 - 5):
        a = sample_weights(zs, state, w, carried="packed2", device="cpu")
        b = sample_weights(zs, dec, w, device="cpu")
        for p in zs.specs:
            assert torch.equal(a[p], b[p])
    test = {"x": torch.from_numpy(ds.x_test), "y": torch.from_numpy(ds.y_test)}
    acc = evaluate(zs, state, lambda prm: tmlp.mlp_accuracy(prm, test),
                   [3, 4], carried="packed2", device="cpu")
    assert acc == evaluate(zs, dec, lambda prm: tmlp.mlp_accuracy(prm, test),
                           [3, 4], device="cpu")
    with pytest.raises(ValueError, match="ambiguous"):
        sample_weights(zs, state, 3, device="cpu")
    with pytest.raises(ValueError, match="packed4"):
        sample_weights(zs, state, 3, carried="packed4", device="cpu")


def test_encode_state_by_signature_and_convert(wire):
    """A packed carry passes encode_state unchanged under its own codec
    and raises under another packed width; JAX's packed state carries
    across to the port's lanes exactly."""
    zs = wire["zs"]
    cfg, jcfg, st, jst = _states(wire, downlink="packed4")
    again = tfed.encode_state(zs, cfg, st, 9, device="cpu")
    for p in zs.specs:
        assert again["scores"][p] is st["scores"][p]
    with pytest.raises(ValueError, match="ambiguous"):
        tfed.encode_state(zs, tfed.FederatedConfig(**{**FC,
                                                      "downlink": "packed2"}),
                          st, device="cpu")
    zs2, cst = convert.federated_state_from_jax(wire["jzs"], jst,
                                                device="cpu")
    for p in zs2.specs:
        assert cst["scores"][p].dtype == torch.uint32
        np.testing.assert_array_equal(_lanes(cst["scores"][p]),
                                      _lanes(st["scores"][p]))
