"""The port's streaming serve engine against the JAX package's, on a
reduced qwen2-0.5b (2 layers, d_model 256), plus the continuous-batching
scheduler inside the port.

A JAX ``ServeState`` (u8 words from numpy scores) goes through
``repro_torch.convert``; both engines are teacher-forced with the same
tokens and their per-step logits compared at rtol = atol = 1e-4 (Box-
Muller's log/cos and XLA's summation order differ in the last bits; the
mask bits match exactly).  Inside the port, each scheduler lane's
logits equal the single-request (B=1) run bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import ZamplingConfig as JZC, build_specs as jbuild_specs
from repro.core.zampling import _flatten
from repro.models import build_model as jbuild_model
from repro.serve import build_serve_engine as jbuild_engine
from repro.serve import make_generator as jmake_generator
from repro.serve import make_serve_state as jmake_serve_state
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models.model import build_model
from repro_torch.serve import (ServeConfig, ServeScheduler,
                               build_serve_engine, serve_generate)

RTOL = ATOL = 1e-4
TOKENS = [5, 17, 42, 7]
SEQ = 12


def _jax_state(cfg, min_size, seed=0):
    jmodel = jbuild_model(cfg)
    tmpl = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    zspecs = jbuild_specs(tmpl, JZC(compression=8, d=8, min_size=min_size))
    rng = np.random.RandomState(seed)
    flat = dict(_flatten(tmpl))
    scores = {p: jnp.asarray(rng.rand(s.n).astype(np.float32))
              for p, s in zspecs.specs.items()}
    dense = {p: jnp.asarray((1 + 0.1 * rng.randn(*flat[p].shape))
                            .astype(np.float32)).astype(flat[p].dtype)
             for p in zspecs.dense_paths}
    sstate = jmake_serve_state(zspecs, {"scores": scores, "dense": dense}, 2,
                               downlink="u8")
    return jmodel, sstate


@pytest.fixture(scope="module")
def served():
    jmodel, jstate = _jax_state(jget_arch("qwen2-0.5b").reduced(), 1024)
    eng = jbuild_engine(jmodel, jstate, mode="streaming", impl="chunked")
    step = jax.jit(eng.step)
    arrays = eng.arrays_of(jstate)
    cache = eng.init_cache(1, SEQ)
    logits = []
    for t in TOKENS:
        lg, cache = step(arrays, cache, jnp.asarray([[t]], jnp.int32))
        logits.append(np.asarray(lg[0, 0]))
    state = convert.serve_state_from_jax(jstate, device="cpu")
    model = build_model(get_arch("qwen2-0.5b").reduced())
    return jstate, logits, state, model


def test_convert_carries_words_dense_and_step(served):
    jstate, _, state, _ = served
    assert state.codec == "u8" and state.step == int(jstate.step)
    assert list(state.words) == list(jstate.words)
    for p, w in jstate.words.items():
        assert state.words[p].dtype == torch.uint8
        assert (state.words[p].numpy() == np.asarray(w)).all()
    for p, d in jstate.dense.items():
        assert (state.dense[p].numpy() == np.asarray(d, np.float32)).all()


def test_teacher_forced_logits_match_jax(served):
    _, jlogits, state, model = served
    eng = build_serve_engine(model, state, device="cpu")
    arrays = eng.arrays_of(state)
    cache = eng.init_cache(1, SEQ)
    for t, ref in zip(TOKENS, jlogits):
        lg, cache = eng.step(arrays, cache, torch.tensor([[t]]))
        assert lg.shape == (1, 1, ref.shape[-1])
        np.testing.assert_allclose(lg[0, 0].numpy(), ref, rtol=RTOL,
                                   atol=ATOL)
    assert int(cache.pos) == len(TOKENS)


def test_scheduler_lanes_equal_single_request(served):
    _, _, state, model = served
    eng = build_serve_engine(model, state, device="cpu")
    arrays = eng.arrays_of(state)
    prompts = [[5, 17, 42], [1, 2], [9, 9, 1, 0]]
    # step-level: every lane's logits equal its own B=1 run, bitwise
    lanes = eng.init_lane_cache(3, SEQ)
    singles = [eng.init_cache(1, SEQ) for _ in prompts]
    for i in range(2):
        tok = torch.tensor([[p[i]] for p in prompts])
        lg, lanes = eng.step(arrays, lanes, tok, torch.ones(3, dtype=torch.bool))
        for b, p in enumerate(prompts):
            one, singles[b] = eng.step(arrays, singles[b],
                                       torch.tensor([[p[i]]]))
            assert torch.equal(lg[b], one[0])
    # request-level: ragged prompts through 2 lanes; the third request
    # takes over the lane the second one retired from
    ragged = [[5, 17], [1], [9, 9, 1]]
    sched = ServeScheduler(model, state, ServeConfig(
        lanes=2, seq_len=SEQ, mode="streaming", max_new_tokens=2),
        engine=eng, device="cpu")
    rids = [sched.submit(p) for p in ragged]
    results = sched.run()
    assert sched.metrics()["completed"] == 3 and sched.steps == 6
    out = serve_generate(model, state, torch.tensor([ragged[2]]), 2,
                         seq_len=SEQ, device="cpu")
    assert out[0, 3:].tolist() == results[rids[2]].tolist()


def test_later_modes_and_branches_raise(served):
    """What still raises now that load and cached serve: an unknown
    mode, and a cached engine asked for its arrays without a cache;
    ``ServeConfig()``'s cached scheduler (budget 0) runs and gives the
    streaming scheduler's tokens."""
    _, _, state, model = served
    with pytest.raises(ValueError, match="unknown serve mode"):
        build_serve_engine(model, state, mode="turbo", device="cpu")
    eng = build_serve_engine(model, state, mode="cached", device="cpu")
    with pytest.raises(ValueError, match="HotBlockCache"):
        eng.arrays_of(state)
    out = {}
    for mode in ("cached", "streaming"):
        sched = ServeScheduler(model, state, ServeConfig(
            mode=mode, max_new_tokens=2, seq_len=SEQ), device="cpu")
        rid = sched.submit([5, 17])
        out[mode] = sched.run()[rid].tolist()
        assert ("cache" in sched.metrics()) == (mode == "cached")
    assert out["cached"] == out["streaming"]
    assert ServeConfig().mode == "cached"


def test_jax_bf16_cache_promotes_to_f32():
    """The JAX streaming engine writes float32 projections into a bf16
    KV cache: the generation scan refuses the changed carry dtype, and
    under jit the lane cache comes out float32.  The port keeps the
    cache float32 from the start."""
    cfg = dataclasses.replace(jget_arch("qwen2-0.5b").reduced(),
                              dtype="bfloat16")
    jmodel, jstate = _jax_state(cfg, 65536)
    eng = jbuild_engine(jmodel, jstate, mode="streaming", impl="chunked")
    cache = eng.init_cache(1, 4)
    assert cache.k.dtype == jnp.bfloat16
    run = jmake_generator(eng.step, 1)
    with pytest.raises(TypeError, match="carry"):
        run(eng.arrays_of(jstate), cache, jnp.asarray([[1]], jnp.int32),
            jax.random.PRNGKey(0))
    lanes = eng.init_lane_cache(2, 4)
    _, out = jax.jit(eng.step)(eng.arrays_of(jstate), lanes,
                               jnp.zeros((2, 1), jnp.int32),
                               jnp.ones((2,), bool))
    assert out.k.dtype == jnp.float32
    state = convert.serve_state_from_jax(jstate, device="cpu")
    port = build_serve_engine(build_model(cfg), state, device="cpu")
    assert port.init_cache(1, 4).k.dtype == torch.float32
