"""What ``test_torch_serve_modes.py`` and ``test_torch_serve_delta.py``
share: the reduced qwen2-0.5b of ``tests/test_torch_serve_engine.py`` (2
layers, d_model 256) at two rounds of scores, its JAX and port serving
states, full tile caches and the streaming engine's logits.  Each is
built once a process, when a test first asks for it, so the two files
share them when one worker runs both.  A test that changes a cache
takes a ``copy.deepcopy``.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import ZamplingConfig as JZC, build_specs as jbuild_specs
from repro.core.zampling import _flatten
from repro.models import build_model as jbuild_model
from repro.serve import make_serve_state as jmake_serve_state
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models.model import build_model
from repro_torch.serve import ServeConfig, build_cache, build_serve_engine

TOKENS = [5, 17]
SEQ = 10
DRAW_WORD = 2


def moved_scores(scores, seed=7, frac=0.01, amp=0.05):
    """A synthetic converged round: ``frac`` of the scores move by
    ``amp`` N(0, 1)."""
    rng = np.random.RandomState(seed)
    out = {}
    for p, s in scores.items():
        touch = rng.rand(s.size) < frac
        out[p] = np.where(touch, s + amp * rng.randn(s.size),
                          s).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def setup():
    """The JAX model, specs, dense leaves, the two rounds' scores and
    the port's model."""
    cfg = jget_arch("qwen2-0.5b").reduced()
    jmodel = jbuild_model(cfg)
    tmpl = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    zspecs = jbuild_specs(tmpl, JZC(compression=8, d=8, min_size=1024))
    flat = dict(_flatten(tmpl))
    rng = np.random.RandomState(1)
    dense = {p: (1 + 0.1 * rng.randn(*flat[p].shape)).astype(np.float32)
             for p in zspecs.dense_paths}
    rng = np.random.RandomState(0)
    s0 = {p: rng.rand(s.n).astype(np.float32)
          for p, s in zspecs.specs.items()}
    return SimpleNamespace(jmodel=jmodel, zspecs=zspecs, dense=dense,
                           scores=(s0, moved_scores(s0)),
                           model=build_model(get_arch("qwen2-0.5b").reduced()))


@functools.lru_cache(maxsize=None)
def jax_state(codec: str, rnd: int = 0):
    """The JAX package's serving state of round ``rnd`` (0 or 1): one
    dither word across the rounds, the draw word pinned."""
    s = setup()
    return jmake_serve_state(
        s.zspecs,
        {"scores": {p: jnp.asarray(v) for p, v in s.scores[rnd].items()},
         "dense": {p: jnp.asarray(v) for p, v in s.dense.items()}},
        DRAW_WORD, downlink=codec, dither_word=0)


@functools.lru_cache(maxsize=None)
def port_state(codec: str, rnd: int = 0):
    """``jax_state`` carried over to the port, on the CPU."""
    return convert.serve_state_from_jax(jax_state(codec, rnd), device="cpu")


@functools.lru_cache(maxsize=None)
def full_cache(codec: str, rnd: int = 0):
    """A HotBlockCache of ``port_state(codec, rnd)`` holding every tile."""
    return build_cache(port_state(codec, rnd),
                       ServeConfig(cache_budget_bytes=1 << 30))


@functools.lru_cache(maxsize=None)
def stream_logits(codec: str) -> torch.Tensor:
    """The streaming engine's logits (1, 1, padded_vocab) after
    ``TOKENS[0]`` on round 0: the reference the other modes equal."""
    ts = port_state(codec)
    eng = build_serve_engine(setup().model, ts, device="cpu")
    lg, _ = eng.step(ts.arrays(), eng.init_cache(1, SEQ),
                     torch.tensor([[TOKENS[0]]]))
    return lg
