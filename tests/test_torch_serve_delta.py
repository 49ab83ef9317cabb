"""The port's hot-block tile cache, XOR round deltas and serving byte
meters against the JAX package's, on the reduced qwen2-0.5b of
tests/test_torch_serve_engine.py (2 layers, d_model 256).

Against JAX, exactly: the cache's slot maps, owners, clock hand,
reference bits and counters through one fixed sequence of fills,
evicting fills, steps and invalidations (each owned pool row by bits the port's fill of its block); the delta patches,
flip maps and ``delta_report``'s integer fields on f32, u16, u8 and
packed4 words (the report on f32/u16/u8: the JAX package's raises on a
packed codec, and the port's refuses it); ``delta_wire_bytes``,
``serve_tile_pool_bytes`` and ``serve_resident_bytes``.  Inside the
port, bitwise: every tile a delta retains against a cold fill from the
new words; a cached run after the swap against a streaming one; a
scheduler swapped mid-flight against a fresh one on the new state.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serve_common as common
from repro.comm.metering import delta_wire_bytes as jdelta_wire_bytes
from repro.comm.metering import serve_resident_bytes as jserve_resident_bytes
from repro.comm.metering import serve_tile_pool_bytes as jserve_tile_pool_bytes
from repro.serve import HotBlockCache as JHotBlockCache
from repro.serve import cache as jcache
from repro.serve import apply_delta as japply_delta
from repro.serve import delta_flipped_windows as jdelta_flipped_windows
from repro.serve import delta_report as jdelta_report
from repro.serve import make_delta as jmake_delta
from repro_torch import convert
from repro_torch.comm.metering import (delta_wire_bytes,
                                       serve_resident_bytes,
                                       serve_tile_pool_bytes)
from repro_torch.kernels import ops
from repro_torch.serve import (HotBlockCache, ServeConfig, ServeScheduler,
                               apply_delta, build_cache, build_serve_engine,
                               delta_flipped_windows, delta_report,
                               make_delta, make_serve_state, serve_generate)

CODECS = ("f32", "u16", "u8", "packed4")
TILE = 4 * ops.SERVE_BM
RAGGED = [[5, 17, 42], [1, 2], [9, 9, 1, 0]]
NEW = 2


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests run beside other test processes,
    and torch's thread pools would only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rounds():
    """({codec: (JAX state t, JAX state t+1, port state t, port state
    t+1)}, the port's model, the JAX specs, the dense leaves, the two
    rounds' scores); one dither word across the rounds, the draw word
    pinned (``_torch_serve_common``)."""
    st = common.setup()
    out = {c: (common.jax_state(c, 0), common.jax_state(c, 1),
               common.port_state(c, 0), common.port_state(c, 1))
           for c in CODECS}
    return out, st.model, st.zspecs, st.dense, st.scores


def _u(a):
    """A word array's bit pattern as numpy unsigned integers."""
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _patch_bits(t):
    return np.asarray(t.view(torch.int32) if t.dtype == torch.uint32
                      else t.view(torch.int16) if t.dtype == torch.uint16
                      else t).view({4: np.uint32, 2: np.uint16,
                                    1: np.uint8}[t.element_size()])


def _eq(a, b):
    """Equal by bits (torch compares no uint32 on the CPU)."""
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def _same_cache(t, j, ts):
    """The port's cache ``t`` holds JAX's ``j`` bookkeeping exactly, and
    each owned pool row the tile of its block."""
    assert list(t.slots) == list(j.slots)
    for p in j.slots:
        assert np.array_equal(t.slots[p], j.slots[p]), p
    assert np.array_equal(t._owner, j._owner)
    assert np.array_equal(t._ref, j._ref)
    assert t._hand == j._hand and t.counters == j.counters
    assert t.stats() == j.stats()
    for pi, path in enumerate(t._paths):
        k = np.nonzero(t._owner[:, 0] == pi)[0]
        if k.size:
            want = ops.serve_fill_tiles(
                t.grids[path].spec, ts.words[path], ts.step,
                torch.from_numpy(t._owner[k, 1]),
                torch.from_numpy(t._owner[k, 2]), qbits=t.qbits)
            assert torch.equal(t.pool[torch.from_numpy(k)].view(torch.int32),
                               want.view(torch.int32)), path


@pytest.mark.parametrize("tiles", [8, 40])
def test_cache_bookkeeping_matches_jax(rounds, tiles, monkeypatch):
    """JAX's pool values are held to the port's by the fill test of
    tests/test_torch_serve_modes.py; here its fill writes zeros, so each
    call compiles nothing."""
    monkeypatch.setattr(jcache.ops, "serve_fill_tiles",
                        lambda spec, w, step, gs, ts, **kw: jnp.zeros(
                            (gs.shape[0], ops.SERVE_BM), jnp.float32))
    states, _, _, _, _ = rounds
    js, _, ts, _ = states["u8"]
    jc, tc = JHotBlockCache(js, tiles * TILE + 5), HotBlockCache(
        ts, tiles * TILE + 5)
    assert tc.capacity == jc.capacity == tiles
    steps = [
        lambda c, s: c.fill(s, limit=tiles // 2),
        lambda c, s: c.fill(s),
        lambda c, s: c.fill(s),  # full: a plain fill admits nothing
        lambda c, s: c.fill(s, limit=3, evict=True),
        lambda c, s: c.record_step(2),
        lambda c, s: c.fill(s, limit=tiles + 2, evict=True),
        lambda c, s: c.invalidate_windows(
            "blocks/attn/wq", np.arange(s.zspecs.specs[
                "blocks/attn/wq"].num_windows) % 3 == 0),
        lambda c, s: c.invalidate_windows(
            "blocks/mlp/down", np.ones(s.zspecs.specs[
                "blocks/mlp/down"].num_windows, bool)),
        lambda c, s: c.fill(s, limit=5),
        lambda c, s: c.record_step(),
        lambda c, s: c.invalidate_all(),
        lambda c, s: c.fill(s, evict=True),
    ]
    for i, op in enumerate(steps):
        assert op(tc, ts) == op(jc, js), i
        _same_cache(tc, jc, ts)
    assert tc.counters["evictions"] > 0 and tc.counters["invalidations"] > 0


def test_budget_dial_and_pool_meter(rounds):
    states, _, zspecs, _, _ = rounds
    ts = states["u8"][2]
    c0 = build_cache(ts, ServeConfig(cache_budget_bytes=0))
    assert c0.capacity == 0 and c0.fill(ts) == 0 and c0.pool.shape == (1, 256)
    c0.record_step(3)
    assert c0.counters["misses"] == 3 * c0.total_tiles
    cf = common.full_cache("u8")
    assert cf.capacity == cf.resident_tiles == cf.total_tiles
    assert cf.used_bytes == cf.capacity_bytes
    tz = convert.zspecs_from_jax(zspecs)
    for budget in (0, 12345, 17 * TILE + 5, 1 << 20, 1 << 30):
        got = serve_tile_pool_bytes(tz, budget)
        assert got == jserve_tile_pool_bytes(zspecs, budget), budget
        assert got == HotBlockCache(ts, budget).capacity_bytes, budget


@pytest.mark.parametrize("codec", CODECS)
def test_delta_patches_and_flip_maps_match_jax(rounds, codec):
    states, _, _, _, _ = rounds
    j0, j1, t0, t1 = states[codec]
    jd, td = jmake_delta(j0, j1), make_delta(t0, t1)
    assert td.codec == jd.codec == codec and td.step == int(jd.step)
    changed = 0
    for p in jd.words:
        assert np.array_equal(_patch_bits(td.words[p]), _u(jd.words[p])), p
        changed += int(np.count_nonzero(_u(jd.words[p])))
    assert changed > 0
    jf, tf = jdelta_flipped_windows(j0, jd), delta_flipped_windows(t0, td)
    assert set(jf) == set(tf)
    for p in jf:
        assert np.array_equal(tf[p].numpy(), np.asarray(jf[p])), p
    assert 0 < sum(int(v.sum()) for v in tf.values())
    # the patched words are round t+1's by bits, as JAX's are
    jn, tn = japply_delta(j0, jd), apply_delta(t0, td)
    for p in t1.words:
        assert np.array_equal(_patch_bits(tn.words[p]), _u(t1.words[p]))
        assert np.array_equal(_u(jn.words[p]), _u(j1.words[p]))
    if codec.startswith("packed"):
        with pytest.raises(ValueError, match="packed"):
            delta_report(t0, t1)
        with pytest.raises(Exception):
            jdelta_report(j0, j1)
        return
    jr, tr = jdelta_report(j0, j1), delta_report(t0, t1)
    for k in ("codec", "words_total", "words_changed", "words_flipped",
              "delta_bytes", "full_bytes", "delta_vs_full"):
        assert tr[k] == jr[k], k
    assert tr["per_path"] == jr["per_path"]
    assert tr["words_flipped"] <= tr["words_changed"]


def test_meters_match_jax(rounds):
    states, model, zspecs, _, _ = rounds
    for total, changed, wb in ((1000, 0, 1), (1000, 7, 1), (1 << 20, 900, 2),
                               (4096, 4096, 4), (33, 5, 0)):
        assert (delta_wire_bytes(total, changed, wb)
                == jdelta_wire_bytes(total, changed, wb))
    with pytest.raises(ValueError):
        delta_wire_bytes(10, 11, 1)
    js, _, ts, _ = states["u8"]
    assert ts.loaded_zampled_bytes() == js.loaded_zampled_bytes()
    assert ts.dense_bytes() == js.dense_bytes()
    assert ts.resident_zampled_bytes() == js.resident_zampled_bytes()
    kv = build_serve_engine(model, ts, device="cpu").init_cache(1, 16)
    for mode, budget in (("load", 0), ("streaming", 0), ("cached", 1 << 20),
                         ("cached", 1 << 30)):
        got = serve_resident_bytes(ts, budget, mode=mode, kv_cache=kv)
        ref = jserve_resident_bytes(js, budget, mode=mode)
        for k in ("mode", "zampled_bytes", "cache_bytes", "dense_bytes"):
            assert got[k] == ref[k], (mode, k)
        assert got["kv_bytes"] == sum(t.numel() * t.element_size()
                                      for t in kv)
        assert got["total_bytes"] == ref["total_bytes"] + got["kv_bytes"]
    with pytest.raises(ValueError):
        serve_resident_bytes(ts, mode="turbo")


@pytest.mark.parametrize("codec", ["u8", "packed4"])
def test_retained_tiles_equal_cold_fill(rounds, codec):
    states, _, _, _, _ = rounds
    _, _, t0, t1 = states[codec]
    cache = copy.deepcopy(common.full_cache(codec, 0))
    new = apply_delta(t0, make_delta(t0, t1), cache=cache)
    assert 0 < cache.resident_tiles < cache.total_tiles
    for path, slots in cache.slots.items():
        g, t = np.nonzero(slots >= 0)
        fresh = ops.serve_fill_tiles(
            cache.grids[path].spec, new.words[path], new.step,
            torch.from_numpy(g), torch.from_numpy(t), qbits=cache.qbits,
            qpacked=cache.qpacked)
        got = cache.pool[torch.from_numpy(slots[g, t]).long()]
        assert torch.equal(got.view(torch.int32), fresh.view(torch.int32))
    # the refill takes exactly the freed slots
    freed = cache.total_tiles - cache.resident_tiles
    assert cache.fill(new) == freed
    assert cache.resident_tiles == cache.total_tiles


def test_flip_map_needs_the_pinned_draw(rounds):
    states, _, _, _, _ = rounds
    _, _, t0, t1 = states["u8"]
    moved = t1.replace_arrays({**t1.arrays(), "step": 3})
    delta = make_delta(t0, moved)
    with pytest.raises(ValueError, match="draw word"):
        delta_flipped_windows(t0, delta)
    cache = copy.deepcopy(common.full_cache("u8", 0))
    new = apply_delta(t0, delta, cache=cache)
    assert cache.resident_tiles == 0 and new.step == 3
    with pytest.raises(ValueError, match="codec"):
        apply_delta(states["u16"][2], delta)
    with pytest.raises(ValueError, match="across codecs"):
        make_delta(t0, states["u16"][3])


def test_post_swap_cached_equals_streaming(rounds):
    states, model, _, _, _ = rounds
    _, _, t0, t1 = states["u8"]
    cache = copy.deepcopy(common.full_cache("u8", 0))
    new = apply_delta(t0, make_delta(t0, t1), cache=cache)
    cache.fill(new)
    prompt = torch.tensor([[1]])
    kw = dict(seq_len=4, device="cpu")
    got = serve_generate(model, new, prompt, NEW, mode="cached", cache=cache,
                         **kw)
    assert torch.equal(got, serve_generate(model, t1, prompt, NEW, **kw))


def test_round_delta_mid_flight(rounds):
    """A cached scheduler swapped to round t+1 after one step: its words
    are round t+1's by bits, its pool a fresh round-t+1 pool, and the
    requests it takes after the swap give a fresh round-t+1 scheduler's
    tokens."""
    states, model, _, _, _ = rounds
    _, _, t0, t1 = states["u8"]
    ragged = RAGGED[:2]
    scfg = ServeConfig(lanes=2, seq_len=max(map(len, ragged)) + NEW,
                       cache_budget_bytes=1 << 30, max_new_tokens=NEW)
    sched = ServeScheduler(model, t0, scfg, device="cpu",
                           cache=copy.deepcopy(common.full_cache("u8", 0)))
    for p in ragged:
        sched.submit(p)
    sched.step_once()
    new = sched.apply_round_delta(make_delta(t0, t1))
    for p in t1.words:
        assert _eq(new.words[p], t1.words[p])
    sched.run()
    fresh = ServeScheduler(model, t1, scfg, device="cpu",
                           cache=copy.deepcopy(common.full_cache("u8", 1)))
    c = sched.metrics()["cache"]
    assert c["resident_tiles"] == c["total_tiles"]
    assert 0 < c["invalidations"] < c["total_tiles"]
    assert torch.equal(sched.cache.pool.view(torch.int32),
                       fresh.cache.pool.view(torch.int32))
    rids = [sched.submit(p) for p in ragged]
    fids = [fresh.submit(p) for p in ragged]
    got, want = sched.run(), fresh.run()
    for a, b in zip(rids, fids):
        assert got[a].tolist() == want[b].tolist()


def test_swap_state_drops_and_refills(rounds):
    states, model, _, _, _ = rounds
    _, _, t0, t1 = states["u8"]
    scfg = ServeConfig(lanes=2, seq_len=4, cache_budget_bytes=1 << 30,
                       max_new_tokens=NEW)
    sched = ServeScheduler(model, t0, scfg, device="cpu",
                           cache=copy.deepcopy(common.full_cache("u8", 0)))
    sched.swap_state(t1)
    c = sched.metrics()["cache"]
    assert c["invalidations"] == c["resident_tiles"] == c["total_tiles"]
    fresh = common.full_cache("u8", 1)
    assert torch.equal(sched.cache.pool.view(torch.int32),
                       fresh.pool.view(torch.int32))
    rid = sched.submit([5, 17])
    want = serve_generate(model, t1, torch.tensor([[5, 17]]), NEW, seq_len=4,
                          mode="cached", cache=fresh, device="cpu")
    assert sched.run()[rid].tolist() == want[0, 2:].tolist()


def test_port_state_encodes_as_jax(rounds):
    """The port's own make_serve_state on the same scores gives JAX's
    words by bits, packed lanes included (so a delta between two port
    states is JAX's delta)."""
    states, _, zspecs, dense, (s0, _) = rounds
    tz = convert.zspecs_from_jax(zspecs)
    for codec in ("u8", "packed4"):
        own = make_serve_state(tz, {"scores": s0, "dense": dense}, 2,
                               downlink=codec, dither_word=0, device="cpu")
        ref = states[codec][2]
        assert own.codec == codec and own.qpacked == (codec == "packed4")
        for p in ref.words:
            assert _eq(own.words[p], ref.words[p]), (codec, p)
        carried = make_serve_state(tz, {"scores": own.words,
                                        "dense": dense}, 2, carried=codec,
                                   device="cpu")
        assert all(_eq(carried.words[p], own.words[p])
                   for p in own.words)

