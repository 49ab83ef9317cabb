"""The port's load and cached serving modes, packed lanes in the serve
ops, and serving from the compressed mask artifact, against the JAX
package's, on the reduced qwen2-0.5b of tests/test_torch_serve_engine.py
(2 layers, d_model 256), u8 words and packed4 lanes
(``_torch_serve_common`` builds the states once a process).

Against JAX: teacher-forced logits of the port's load and cached
engines against the JAX cached engine's on packed4 lanes with a partial
cache (one JAX jit; the JAX modes give the same logits, and JAX's pool
and regenerated blocks both take part) at rtol = atol = 1e-4, as the
streaming test compares (Box-Muller's log/cos and XLA's summation order
differ in the last bits); ``serve_fill_tiles``, ``serve_cached_matmul``
and ``serve_resident_matmul`` allclose; the dense decoder's
``decode_step`` on weights from masks allclose.  Inside the port,
bitwise: the three modes' logits at cache budgets 0, partial and full; a
cached scheduler's lanes against their B=1 requests.  The kernels'
checks on the card carry the ``gpu`` marker and skip here.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serve_common as common
from _torch_serve_common import SEQ, TOKENS
from repro.comm.downlink import get_codec as jget_codec
from repro.core.zampling import unflatten_like
from repro.core.qspec import make_qspec as jmake_qspec
from repro.core.sampling import as_word
from repro.kernels import ops as jops
from repro.serve import HotBlockCache as JHotBlockCache
from repro.serve import build_serve_engine as jbuild_engine
from repro_torch import convert
from repro_torch.comm.downlink import get_codec
from repro_torch.core.qspec import make_qspec
from repro_torch.core.zampling import weights_from_masks
from repro_torch.kernels import ops, qz_decode
from repro_torch.serve import (HotBlockCache, ServeConfig, ServeScheduler,
                               build_serve_engine, generate,
                               serve_from_compressed, serve_generate)

RTOL = ATOL = 1e-4
CODECS = ("u8", "packed4")
PARTIAL = 40 * 4 * 256  # 40 tiles of the reduced model's 5120


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests run beside other test processes,
    and torch's thread pools would only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_cached_logits():
    """The JAX cached engine's logits after ``TOKENS[0]`` on packed4
    lanes with a partial cache, jitted once."""
    js = common.jax_state("packed4")
    jeng = jbuild_engine(common.setup().jmodel, js, mode="cached",
                         impl="chunked")
    jcache = JHotBlockCache(js, PARTIAL)
    assert jcache.fill(js) == 40
    lg, _ = jax.jit(jeng.step)(jeng.arrays_of(js, cache=jcache),
                               jeng.init_cache(1, SEQ),
                               jnp.asarray([[TOKENS[0]]], jnp.int32))
    return np.asarray(lg)[0, 0]


@pytest.mark.parametrize("mode", ["load", "cached"])
def test_load_and_cached_logits_match_jax(mode):
    """The port's engine in ``mode`` on packed4 lanes against one JAX
    reference; u8 words equal these inside the port by bits
    (``test_three_modes_bitwise_across_budgets``), and the streaming
    engine is held to JAX's on u8 in tests/test_torch_serve_engine.py."""
    ts = common.port_state("packed4")
    assert ts.qpacked and ts.codec == "packed4"
    eng = build_serve_engine(common.setup().model, ts, mode=mode,
                             device="cpu")
    cache = None
    if mode == "cached":
        cache = HotBlockCache(ts, PARTIAL)
        assert cache.fill(ts) == 40
    lg, _ = eng.step(eng.arrays_of(ts, cache=cache), eng.init_cache(1, SEQ),
                     torch.tensor([[TOKENS[0]]]))
    np.testing.assert_allclose(lg[0, 0].numpy(), _jax_cached_logits(),
                               rtol=RTOL, atol=ATOL)


def _small(codec, shape=(2, 48, 320), tid=21):
    kw = dict(compression=4.0, d=4, window=64)
    jspec = jmake_qspec(tid, shape, shape[-2], **kw)
    tspec = make_qspec(tid, shape, shape[-2], **kw)
    s = np.random.RandomState(3).rand(jspec.n).astype(np.float32)
    jc, tc = jget_codec(codec), get_codec(codec)
    return (jspec, tspec, jc.encode(jspec, jnp.asarray(s), as_word(3)),
            tc.encode(tspec, torch.from_numpy(s), 3), jc.bits)


@pytest.mark.parametrize("codec", CODECS)
def test_fill_cached_and_resident_ops_match_jax(codec):
    jspec, tspec, jw, tw, bits = _small(codec)
    qp = codec == "packed4"
    groups, d_in, _ = ops.serve_group_dims(tspec)
    _, nblk, _ = ops.serve_block_grid(tspec, ops.SERVE_BM, 0, d_in * 320)
    gs = np.repeat(np.arange(groups), nblk).astype(np.int32)
    ts = np.tile(np.arange(nblk), groups).astype(np.int32)
    jt = np.asarray(jops.serve_fill_tiles(jspec, jw, as_word(5),
                                          jnp.asarray(gs), jnp.asarray(ts),
                                          qbits=bits, qpacked=qp))
    tt = ops.serve_fill_tiles(tspec, tw, 5, torch.from_numpy(gs),
                              torch.from_numpy(ts), qbits=bits, qpacked=qp)
    np.testing.assert_allclose(tt.numpy(), jt, rtol=RTOL, atol=ATOL)
    assert torch.equal(tt == 0, torch.from_numpy(jt == 0))
    X = np.random.RandomState(4).randn(3, d_in).astype(np.float32)
    W = np.asarray(jops.sample_reconstruct(jspec, jw, as_word(5), qbits=bits,
                                           qpacked=qp, impl="ref"))
    for g in range(groups):
        slots = np.arange(g * nblk, (g + 1) * nblk, dtype=np.int32)
        slots[::2] = -1
        ref = np.asarray(jops.serve_cached_matmul(
            jspec, jw, as_word(5), jnp.asarray(X), jnp.asarray(jt),
            jnp.asarray(slots), group=g, qbits=bits, qpacked=qp))
        got = ops.serve_cached_matmul(tspec, tw, 5, torch.from_numpy(X), tt,
                                      torch.from_numpy(slots), group=g,
                                      qbits=bits, qpacked=qp)
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
        ref = np.asarray(jops.serve_resident_matmul(jspec, jnp.asarray(W),
                                                    jnp.asarray(X), group=g))
        res = ops.serve_resident_matmul(tspec, torch.from_numpy(W.copy()),
                                        torch.from_numpy(X), group=g)
        np.testing.assert_allclose(res.numpy(), ref, rtol=RTOL, atol=ATOL)
        # inside the port the three sources give one result by bits
        stream = ops.serve_matmul(tspec, tw, 5, torch.from_numpy(X),
                                  group=g, qbits=bits, qpacked=qp)
        assert torch.equal(got, stream)
        assert torch.equal(ops.serve_resident_matmul(
            tspec, ops.sample_reconstruct(tspec, tw, 5, qbits=bits,
                                          qpacked=qp),
            torch.from_numpy(X), group=g), stream)
        # a batch row equals a batch of one (B=1 is the matmul's)
        assert torch.equal(ops.serve_cached_matmul(
            tspec, tw, 5, torch.from_numpy(X[1:2]), tt,
            torch.from_numpy(slots), group=g, qbits=bits, qpacked=qp),
            stream[1:2])


@pytest.mark.parametrize("codec", CODECS)
def test_three_modes_bitwise_across_budgets(codec):
    """Every budget on u8; the partial one, which takes both sources in
    one contraction, on packed4 lanes.  The first step's logits: from
    the second step on, attention's products go through the CPU BLAS,
    whose summation order nothing here pins."""
    ts = common.port_state(codec)
    model = common.setup().model
    ref = common.stream_logits(codec)

    def logits(eng, arrays):
        lg, _ = eng.step(arrays, eng.init_cache(1, SEQ),
                         torch.tensor([[TOKENS[0]]]))
        return lg

    load = build_serve_engine(model, ts, mode="load", device="cpu")
    assert torch.equal(logits(load, load.arrays_of(ts)), ref)
    cached = build_serve_engine(model, ts, mode="cached", device="cpu")
    for budget in ((0, PARTIAL, 1 << 30) if codec == "u8" else (PARTIAL,)):
        if budget == 1 << 30:
            cache = common.full_cache(codec)
        else:
            cache = HotBlockCache(ts, budget)
            cache.fill(ts)
        assert cache.resident_tiles == min(budget // 1024, cache.total_tiles)
        assert torch.equal(logits(cached, cached.arrays_of(ts, cache)), ref)


def test_cached_scheduler_lanes_equal_single_requests():
    ts = common.port_state("u8")
    model = common.setup().model
    ragged = [[5, 17, 42], [1, 2]]
    new = 2
    seq = max(map(len, ragged)) + new
    sched = ServeScheduler(model, ts, ServeConfig(
        lanes=2, seq_len=seq, cache_budget_bytes=1 << 30, mode="cached",
        max_new_tokens=new), device="cpu",
        cache=copy.deepcopy(common.full_cache("u8")))
    rids = {sched.submit(p): p for p in ragged}
    results = sched.run()
    m = sched.metrics()["cache"]
    assert m["resident_tiles"] == m["total_tiles"]
    assert m["hits"] == m["total_tiles"] * sched.steps and m["misses"] == 0
    for rid, p in rids.items():
        one = serve_generate(model, ts, torch.tensor([p]), new, mode="cached",
                             seq_len=seq, cache=sched.cache, device="cpu")
        assert one[0, len(p):].tolist() == results[rid].tolist(), p


def test_decode_step_and_serve_from_compressed_match_jax():
    """The port's ``weights_from_masks`` against JAX's plain reference
    reconstruction at a stacked leaf and the embedding (the other leaves
    run the same code), then both dense decoders on the port's
    weights."""
    st = common.setup()
    jmodel, zspecs, dense, model = st.jmodel, st.zspecs, st.dense, st.model
    scores = st.scores[0]
    rng = np.random.RandomState(7)
    masks = {p: (rng.rand(s.n) < scores[p]).astype(np.float32)
             for p, s in zspecs.specs.items()}
    tzspecs = convert.zspecs_from_jax(zspecs)
    tmasks = {p: torch.from_numpy(m) for p, m in masks.items()}
    tdense = {p: torch.from_numpy(v) for p, v in dense.items()}
    params = weights_from_masks(tzspecs, tmasks, {"dense": tdense})
    for p in ("blocks/attn/wq", "embed"):
        ref = jops.reconstruct(zspecs.specs[p], jnp.asarray(masks[p]),
                               impl="ref")
        np.testing.assert_allclose(params[p].numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)
    jparams = unflatten_like(zspecs.template, {
        p: jnp.asarray(v.numpy()) for p, v in params.items()})
    jcache = jmodel.init_cache(jparams, 1, SEQ)
    cache = model.init_cache(params, 1, SEQ)
    jstep = jax.jit(jmodel.decode_step)
    for t in TOKENS:
        jl, jcache = jstep(jparams, jcache,
                           {"tokens": jnp.asarray([[t]], jnp.int32)})
        lg, cache = model.decode_step(params, cache,
                                      {"tokens": torch.tensor([[t]])})
        np.testing.assert_allclose(lg[0, 0].numpy(), np.asarray(jl)[0, 0],
                                   rtol=RTOL, atol=ATOL)
    out = serve_from_compressed(model, tzspecs, tmasks, tdense,
                                torch.tensor([TOKENS]), 2, device="cpu")
    assert torch.equal(out, generate(model, params, torch.tensor([TOKENS]), 2,
                                     device="cpu"))
    assert out.shape == (1, len(TOKENS) + 2)


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qz_decode.build()
    return torch.device("cuda")


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ("f32", "u8", "u16", "packed4", "packed2"))
def test_sources_and_fill_bitwise_on_card(cuda, codec):
    """Kernels 11/12 with the regenerating (packed lanes too), resident
    and cached sources, the fill kernel and kernel 7's leaf, each against
    its plain version on the card, by bits; one launch a call."""
    spec = make_qspec(7, (3, 200, 320), 200, compression=4.0, d=8,
                      window=256)
    groups, d_in, d_out = ops.serve_group_dims(spec)
    s = torch.from_numpy(np.random.RandomState(0).rand(spec.n)
                         .astype(np.float32)).to(cuda)
    c = get_codec(codec)
    words = c.encode(spec, s, 3) if c.quantized else s
    qbits, qp = (c.bits if c.quantized else None), bool(c.packed)
    p = ops.serve_operand(words, qbits, qp)
    W = ops.sample_reconstruct(spec, p, 5, qbits=qbits, qpacked=qp)
    assert _same_bits(W, ops.sample_reconstruct(spec, p, 5, qbits=qbits,
                                                qpacked=qp, impl="ref"))
    _, nblk, _ = ops.serve_block_grid(spec, ops.SERVE_BM, 0, d_in * d_out)
    gs = torch.arange(groups).repeat_interleave(nblk)
    ts = torch.arange(nblk).repeat(groups)
    before = dict(qz_decode.LAUNCHES)
    pool = ops.serve_fill_tiles(spec, words, 5, gs, ts, qbits=qbits,
                                qpacked=qp)
    assert qz_decode.LAUNCHES["qz_fill_tiles"] == before["qz_fill_tiles"] + 1
    assert _same_bits(pool, ops.fill_tiles_plain(spec, p, 5, gs, ts, qbits,
                                                 qp))
    for g in range(groups):
        off = g * d_in * d_out
        full = torch.arange(g * nblk, (g + 1) * nblk, dtype=torch.int32,
                            device=cuda)
        half = full.clone()
        half[::2] = -1
        for B in (1, 4):
            X = torch.from_numpy(np.random.RandomState(g + B).randn(
                B, d_in).astype(np.float32)).to(cuda)
            ref = ops.serve_contract_plain(spec, p, 5, X, off, d_in, d_out,
                                           qbits, qpacked=qp)
            kw = dict(row_offset=off, d_in=d_in, d_out=d_out)
            got = [qz_decode.qz_sample_matmul(spec, p, 5, X, qbits=qbits,
                                              qpacked=qp, **kw),
                   qz_decode.qz_resident_matmul(spec, W.reshape(-1), X, **kw)]
            for sl in (torch.full_like(full, -1), half, full):
                got.append(qz_decode.qz_cached_matmul(
                    spec, p, 5, X, pool, sl, qbits=qbits, qpacked=qp, **kw))
                assert _same_bits(ops.serve_contract_plain(
                    spec, p, 5, X, off, d_in, d_out, qbits, qpacked=qp,
                    pool=pool, slots=sl), ref)
            for y in got:
                assert _same_bits(y, ref)
