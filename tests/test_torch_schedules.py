"""The port's downlink schedules against the JAX package's.

At the ``test_torch_wire.py`` setup (SMALL_DIMS 784-20-20-10, K=3
clients, E=2 local steps, batch 8, compression 8, d=10, window 128).
Inputs are seeded numpy arrays and explicit uint32 words; JAX runs under
``jax.jit``, as its fit loops run it.

Exact: the width-tensor threshold, the scheduled words of every codec at
every width, the five metering functions, the cosine widths (rounds
0..H+1 over a grid of horizons, floors and codecs that puts many widths
at x.5), the frontier's next widths, and a 3-round frontier run's
per-round widths and metered bytes.  The frontier's flip fraction is an
f32 mean whose sum order is XLA's, so it is allclose; a round's words
may differ where an upload bit flips within the Box-Muller rounding
(``MAX_FLIP_SHARE``), as in ``test_torch_federated.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import downlink as jdl, metering as jmet
from repro.core import federated as jfed, sampling as js
from repro.models import mlp as jmlp
from repro_torch.comm import downlink as tdl, metering as tmet
from repro_torch.core import federated as tfed, sampling as ts
from repro_torch.models import mlp as tmlp
from test_torch_federated import K, LOSS_RTOL, MAX_FLIP_SHARE
from test_torch_wire import _np, _specs, _states, _words_of
from test_torch_wire import wire  # noqa: F401  (a fixture)

CODECS = ("u8", "u16", "packed4", "packed2")


def _probs(n, seed):
    """Probabilities with exact 0s, 1s and halves among uniform draws."""
    rng = np.random.RandomState(seed)
    p = rng.rand(n).astype(np.float32)
    p[::7], p[1::11], p[2::13] = 0.0, 1.0, 0.5
    return p


def test_threshold_with_a_width_tensor_is_the_static_one():
    q = np.arange(1 << 16, dtype=np.int64)
    for b in range(1, 17):
        qb = q[: 1 << b]
        want = ts.quant_threshold_u24(torch.from_numpy(qb), b)
        got = ts.quant_threshold_u24_dyn(torch.from_numpy(qb),
                                         torch.tensor(b))
        assert torch.equal(got, want)
        jgot = _np(jax.jit(js.quant_threshold_u24_dyn)(
            qb.astype(np.uint32), np.uint32(b)))
        np.testing.assert_array_equal(got.numpy(), jgot.astype(np.int64))
    # a width per coordinate, broadcast
    bs = torch.tensor([1, 3, 8, 16])
    qs = torch.tensor([1, 5, 200, 40000])
    assert torch.equal(ts.quant_threshold_u24_dyn(qs, bs), torch.stack(
        [ts.quant_threshold_u24(qs[i:i + 1], int(bs[i]))[0]
         for i in range(4)]))


@pytest.mark.parametrize("codec", CODECS)
def test_scheduled_words_at_every_width(codec):
    """``encode_at`` at every width up to the codec's against JAX's, and
    at the codec's own width against ``encode``."""
    spec, jspec = _specs()
    c, jc = tdl.get_codec(codec), jdl.get_codec(codec)
    p = _probs(spec.n, 3)
    word = 2**32 - 7
    enc_at = jax.jit(lambda s, b: jc.encode_at(jspec, s, np.uint32(word),
                                               b))
    for b in range(1, c.bits + 1):
        got = c.encode_at(spec, torch.from_numpy(p), word, torch.tensor(b))
        assert got.dtype == c.wire_dtype
        want = _np(enc_at(jnp.asarray(p), np.uint32(b)))
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
        # the same words from a Python int width
        assert torch.equal(c.encode_at(spec, torch.from_numpy(p), word, b),
                           got)
    assert torch.equal(c.encode_at(spec, torch.from_numpy(p), word, c.bits),
                       c.encode(spec, torch.from_numpy(p), word))


def test_metering_functions_exact(wire):
    zs, jzs = wire["zs"], wire["jzs"]
    for n in (1, 31, 32, 33, 1000, 15680):
        for b in range(1, 17):
            want = jmet.scheduled_downlink_bits(n, b)
            assert tmet.scheduled_downlink_bits(n, b) == want
            assert int(tmet.scheduled_downlink_bits(n, torch.tensor(b))) \
                == want == int(jmet.scheduled_downlink_bits(n, jnp.uint32(b)))
    for agg in ("mean_f32", "psum_u32", "allgather_packed"):
        for down in ("u8", "packed4"):
            rep = tmet.round_wire_report(zs, agg, 6, downlink=down)
            jrep = jmet.round_wire_report(jzs, agg, 6, downlink=down)
            for bv in ([1, 2, 3], [8, 5, 2], [16, 16, 16]):
                got = tmet.scheduled_wire_metrics(rep, zs, torch.tensor(bv),
                                                  6)
                want = jmet.scheduled_wire_metrics(
                    jrep, jzs, jnp.asarray(bv, jnp.uint32), 6)
                for key in tfed.WIRE_METRIC_KEYS + ("downlink_vs_f32",):
                    assert float(got[key]) == float(want[key]), key
            for units in (0.0, 3.0, 7.0):
                got = tmet.realized_wire_metrics(rep, torch.tensor(units), 6)
                want = jmet.realized_wire_metrics(jrep, jnp.float32(units),
                                                  6)
                for key in tfed.WIRE_METRIC_KEYS:
                    assert float(got[key]) == float(want[key]), key
            for k in (1, 6, 1024):
                assert tmet.upload_slab_bytes(zs, agg, k) \
                    == jmet.upload_slab_bytes(jzs, agg, k)
                assert tmet.streaming_peak_bytes(zs, agg, k) \
                    == jmet.streaming_peak_bytes(jzs, agg, k)


# (codec, floor, horizon): odd spans at even horizons put t = H/2 at
# x.5, and the u16 and packed4 entries are where XLA's folded constants
# and fused multiply-add decide a width at x.5
COSINE_GRID = ([("u8", b, h) for b in (1, 5) for h in (2, 14, 22)]
               + [("u16", 5, 14), ("u16", 6, 15), ("u16", 10, 15),
                  ("packed4", 1, 14), ("packed4", 1, 26), ("packed2", 1, 4)])


def test_cosine_widths_at_every_round():
    """Rounds 0..H+1 on ``COSINE_GRID`` against the JAX package's jitted
    widths."""
    class Z:
        specs = {"a": None, "b": None}

    halves = 0
    for codec, b_min, h in COSINE_GRID:
        bits = tdl.get_codec(codec).bits
        kw = dict(downlink=codec, downlink_schedule="cosine",
                  schedule_b_min=b_min, schedule_rounds=h)
        cfg, jcfg = tfed.FederatedConfig(**kw), jfed.FederatedConfig(**kw)
        rs = np.arange(h + 2, dtype=np.uint32)
        want = _np(jax.vmap(jax.jit(lambda r: jfed._round_b_vec(
            Z, jcfg, {}, r)))(rs))
        got = np.stack([tfed._round_b_vec(Z, cfg, {}, int(r), "cpu").numpy()
                        for r in rs])
        np.testing.assert_array_equal(got, want)
        assert got[0, 0] == b_min and got[-1, 0] == bits
        halves += h % 2 == 0 and (bits - b_min) % 2 == 1
    assert halves >= 8


def test_frontier_next_widths_and_flip_fraction(wire):
    zs, jzs = wire["zs"], wire["jzs"]
    kw = dict(downlink="u8", downlink_schedule="frontier")
    cfg, jcfg = tfed.FederatedConfig(**kw), jfed.FederatedConfig(**kw)
    next_b = jax.jit(lambda a, bb: jfed._frontier_next_b(jzs, jcfg, a, bb))
    flip = jax.jit(jfed._flip_fraction)
    rng = np.random.RandomState(11)
    for trial in range(4):
        # aggregates of K votes (a lattice the flips see) or smooth
        agg = {p: (rng.randint(0, K + 1, s.n) / np.float32(K)).astype(
            np.float32) if trial % 2 else _probs(s.n, trial)
            for p, s in zs.specs.items()}
        for bv in ([2, 2, 2], [4, 6, 8], [8, 3, 5]):
            b = torch.tensor(bv)
            got = tfed._frontier_next_b(zs, cfg, {
                p: torch.from_numpy(v) for p, v in agg.items()}, b)
            want = _np(next_b(agg, np.asarray(bv, np.uint32)))
            np.testing.assert_array_equal(got.numpy(), want)
            for i, p in enumerate(zs.specs):
                hi = min(bv[i] + 2, 8)
                f = tfed._flip_fraction(torch.from_numpy(agg[p]), b[i],
                                        torch.tensor(hi))
                jf = flip(jnp.asarray(agg[p]), np.uint32(bv[i]),
                          np.uint32(hi))
                np.testing.assert_allclose(float(f), float(jf), rtol=1e-6)


def test_frontier_rounds_against_jax(wire):
    """Three frontier rounds on packed4 lanes, each from the JAX
    package's state of the round before: widths, metered bytes and the
    carry's layout exact, words within the flip share, losses allclose.
    (A fit carries the widths as its rounds do:
    ``test_torch_participation.py``'s streamed frontier fit.)"""
    codec = "packed4"
    zs, jzs = wire["zs"], wire["jzs"]
    # a floor of 3: K=3 clients' votes sit on the 2-bit lattice already
    cfg, jcfg, st, jst = _states(wire, downlink=codec, schedule_b_min=3,
                                 downlink_schedule="frontier")
    assert st["downlink_b"].tolist() == [3] * len(zs.specs)
    np.testing.assert_array_equal(_np(jst["downlink_b"]),
                                  st["downlink_b"].numpy())
    jround = jax.jit(lambda s, bb, key, r: jfed.federated_round(
        jzs, s, jmlp.mlp_loss, bb, key, jcfg, round_index=r))
    batches = wire["batches"] + wire["batches"][:1]
    words = [101, 202, 303]
    widths = []
    for r in range(3):
        b = batches[r]
        jnew, jm = jround(jst, {n: jnp.asarray(v) for n, v in b.items()},
                          np.uint32(words[r]), np.uint32(r))
        start = {"scores": {p: _np(v) for p, v in jst["scores"].items()},
                 "dense": {p: _np(v) for p, v in jst["dense"].items()},
                 "downlink_b": _np(jst["downlink_b"])}
        new, m = tfed.federated_round(zs, start, tmlp.mlp_loss, b, words[r],
                                      cfg, round_index=r, device="cpu")
        np.testing.assert_array_equal(new["downlink_b"].numpy(),
                                      _np(jnew["downlink_b"]))
        widths.append(new["downlink_b"].tolist())
        for name in tfed.WIRE_METRIC_KEYS:
            assert float(m[name]) == float(jm[name]), name
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        jwords = {p: _np(jdl.get_codec(codec).wire_words(
            jzs.specs[p], jnew["scores"][p])) for p in zs.specs}
        got = _words_of(codec, zs, new["scores"])
        differ = sum(int((got[p].to(torch.int64).numpy()
                          != jwords[p].astype(np.int64)).sum())
                     for p in zs.specs)
        assert differ <= MAX_FLIP_SHARE * K * zs.n_total
        jst = jnew
    # the widths moved, and the metered downlink followed them
    assert widths[0] != [3] * len(zs.specs)


def test_cosine_round_and_convert_carry_the_widths(wire):
    """A cosine round meters its width's bits and is encoded at it; a JAX
    frontier state converts with its widths."""
    from repro_torch import convert
    zs = wire["zs"]
    cfg, _, st, _ = _states(wire, downlink="u8", downlink_schedule="cosine",
                            schedule_b_min=3, schedule_rounds=4)
    new, m = tfed.federated_round(zs, st, tmlp.mlp_loss, wire["batches"][0],
                                  9, cfg, round_index=0, device="cpu")
    bits = sum(tmet.scheduled_downlink_bits(s.n, 3) for s in zs.specs.values())
    assert float(m["downlink_bytes_per_client"]) == -(-bits // 8) \
        + 4 * zs.dense_total
    # round 0 sends 3 bits: its words are the 3-bit lattice's, widened
    for p, spec in zs.specs.items():
        assert set(np.unique(new["scores"][p].numpy())) <= {
            (q * 255 + 3) // 7 for q in range(8)}
    _, _, _, jst = _states(wire, downlink="u8", downlink_schedule="frontier")
    _, back = convert.federated_state_from_jax(wire["jzs"], {
        **jst, "downlink_b": np.asarray([2, 4, 6], np.uint32)}, device="cpu")
    assert back["downlink_b"].dtype == torch.int64
    assert back["downlink_b"].tolist() == [2, 4, 6]


def cosine_sweep(horizons=range(1, 41)):
    """Every (codec, floor, horizon, round) of u8, u16, packed4 and
    packed2 over ``horizons``: the points where the port's cosine width
    differs from the JAX package's jitted one, and where a plain float32
    evaluation (a true division by H, no fused multiply-add) does."""
    class Z:
        specs = {"a": None}

    f32 = np.float32
    total, port_off, plain_off = 0, [], []
    for codec in CODECS:
        bits = tdl.get_codec(codec).bits
        for b_min in range(1, bits + 1):
            for h in horizons:
                kw = dict(downlink=codec, downlink_schedule="cosine",
                          schedule_b_min=b_min, schedule_rounds=h)
                cfg, jcfg = (tfed.FederatedConfig(**kw),
                             jfed.FederatedConfig(**kw))
                rs = np.arange(h + 2, dtype=np.uint32)
                want = _np(jax.vmap(jax.jit(lambda r: jfed._round_b_vec(
                    Z, jcfg, {}, r)))(rs))[:, 0]
                for r in rs:
                    total += 1
                    t = min(f32(r), f32(h))
                    plain = f32(b_min) + f32(bits - b_min) * (f32(1) - np.cos(
                        f32(np.pi) * t / f32(h))) * f32(0.5)
                    plain = int(np.clip(np.round(plain), b_min, bits))
                    point = (codec, b_min, h, int(r), int(want[r]))
                    if tfed.cosine_width(cfg, int(r)) != want[r]:
                        port_off.append(point)
                    if plain != want[r]:
                        plain_off.append(point)
    return total, port_off, plain_off


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_schedules.py
    total, port_off, plain_off = cosine_sweep()
    print(f"cosine widths at {total} points: the port's differ from jitted "
          f"JAX at {len(port_off)}, a plain float32 evaluation at "
          f"{len(plain_off)}; e.g. (codec, floor, H, t, JAX's width) "
          f"{plain_off[:3]}")
