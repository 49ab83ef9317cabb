"""The model families' training paths in the port against the JAX
package: one federated LM round of the reduced mamba2, olmoe and zamba2
against JAX's jitted ``federated_round`` (the tolerances and flip share
of ``test_torch_lm_train.py``), three zampling train steps of the
reduced olmoe against JAX's at equal draw words, and ``convert`` of a
JAX state of each family.  Helpers and the reduced configs in
``_torch_families_common.py``; the forward, decode, block and standard
train-step tests in ``test_torch_families.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import federated as jfed, zampling as jz
from repro.core.sampling import as_word as jas_word
from repro.models.model import build_model as jbuild, loss_fn as jloss
from repro.optim import sgd as jsgd
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import federated as tfed
from repro_torch.core.zampling import (ZamplingConfig, build_specs,
                                       init_state)
from repro_torch.data import lm_token_batches
from repro_torch.models.model import (build_model, init_dense, loss_fn,
                                      param_template)
from repro_torch.optim import sgd
from repro_torch.train import steps
from _torch_families_common import K, ZC, _built

# a round, as tests/test_torch_lm_train.py holds qwen2-0.5b
ROUND_LOSS_RTOL = 1e-5
DENSE_ATOL = 1e-6
MAX_FLIP_SHARE = 1e-3
STEP_LOSS_RTOL = 1e-5  # a train step's loss, as test_torch_families.py's


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "olmoe-1b-7b", "zamba2-7b"])
def test_one_lm_round_against_jax(arch, monkeypatch):
    monkeypatch.setenv("REPRO_BWD_PLAN", "scatter")
    cfg, jcfg, jm = _built(arch)
    E, B, S = 2, 2, 16
    zs = build_specs(param_template(cfg), ZamplingConfig(**ZC))
    jzs = jz.build_specs(jax.eval_shape(jm.init_params,
                                        jax.random.PRNGKey(0)),
                         jz.ZamplingConfig(**ZC))
    rng = np.random.RandomState(0)
    scores = {p: rng.rand(s.n).astype(np.float32) for p, s in zs.specs.items()}
    dense = init_dense(cfg, zs.dense_paths, 0)
    toks = next(lm_token_batches(cfg.vocab, K * E * B, S + 1, seed=0)
                ).reshape(K, E, B, S + 1)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., :-1]}
    fc = dict(num_clients=K, local_steps=E, local_lr=0.05)
    key = 77
    new, met = tfed.federated_round(
        zs, init_state(zs, scores, dense, device="cpu"),
        lambda prm, b: loss_fn(cfg, prm, b), batch, key,
        tfed.FederatedConfig(**fc), device="cpu")
    jstate = {"scores": {p: jnp.asarray(v) for p, v in scores.items()},
              "dense": {p: jnp.asarray(v) for p, v in dense.items()}}
    jnew, jmet = jax.jit(lambda s, b: jfed.federated_round(
        jzs, s, lambda prm, bb: jloss(jm, prm, bb), b, np.uint32(key),
        jfed.FederatedConfig(**fc)))(
        jstate, {n: jnp.asarray(v) for n, v in batch.items()})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=ROUND_LOSS_RTOL)
    for p in zs.dense_paths:
        np.testing.assert_allclose(new["dense"][p].numpy(),
                                   np.asarray(jnew["dense"][p]), rtol=0,
                                   atol=DENSE_ATOL)
    differ = sum(int((new["scores"][p].numpy()
                      != np.asarray(jnew["scores"][p])).sum())
                 for p in zs.specs)
    assert differ <= MAX_FLIP_SHARE * K * zs.n_total


def test_zampling_train_step_against_jax():
    cfg, jcfg, jm = _built("olmoe-1b-7b")
    zs = build_specs(param_template(cfg), ZamplingConfig(**ZC))
    jzs = jz.build_specs(jax.eval_shape(jm.init_params,
                                        jax.random.PRNGKey(0)),
                         jz.ZamplingConfig(**ZC))
    rng = np.random.RandomState(2)
    scores = {p: rng.rand(s.n).astype(np.float32) for p, s in zs.specs.items()}
    dense = init_dense(cfg, zs.dense_paths, 1)
    toks = rng.randint(0, cfg.vocab, (3, 2, 17)).astype(np.int32)
    jkey = jax.random.PRNGKey(9)
    jtrain = {"scores": {p: jnp.asarray(v) for p, v in scores.items()},
              "dense": {p: jnp.asarray(v) for p, v in dense.items()}}
    jstep = jax.jit(jsteps.make_zampling_train_step(jm, jzs, jsgd(0.05)))
    jst = jsteps.init_train_state(jtrain, jsgd(0.05))
    st = steps.init_train_state(init_state(zs, scores, dense, device="cpu"),
                                sgd(0.05))
    tstep = steps.make_zampling_train_step(build_model(cfg), zs, sgd(0.05))
    for t in range(3):
        b = {"tokens": toks[t, :, :-1], "labels": toks[t, :, :-1]}
        word = int(jas_word(jax.random.fold_in(jkey, t)))  # JAX's step word
        jst, jm_ = jstep(jst, {n: jnp.asarray(v) for n, v in b.items()}, jkey)
        st, m = tstep(st, {n: torch.from_numpy(v) for n, v in b.items()},
                      word)
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=STEP_LOSS_RTOL)
    assert int(st.step) == int(jst.step) == 3
    for p in zs.dense_paths:
        np.testing.assert_allclose(st.trainable["dense"][p].numpy(),
                                   np.asarray(jst.trainable["dense"][p]),
                                   rtol=0, atol=1e-5)
    for p in zs.specs:
        np.testing.assert_allclose(st.trainable["scores"][p].numpy(),
                                   np.asarray(jst.trainable["scores"][p]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b", "mamba2-1.3b",
                                  "zamba2-7b", "seamless-m4t-medium"])
def test_convert_a_jax_state_of_each_family(arch):
    """A bf16 JAX state: scores f32, the router and SSM scalars f32,
    every other dense leaf bf16, each carried across by bits."""
    jcfg = dataclasses.replace(jreg.get_arch(arch).reduced(),
                               dtype="bfloat16")
    jm = jbuild(jcfg)
    jzs = jz.build_specs(jax.eval_shape(jm.init_params,
                                        jax.random.PRNGKey(0)),
                         jz.ZamplingConfig(**ZC))
    jstate = jz.init_state(jax.random.PRNGKey(1), jzs,
                           dense_init=jm.init_params(jax.random.PRNGKey(0)))
    zs, state = convert.federated_state_from_jax(jzs, jstate, device="cpu")
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="bfloat16")
    assert zs.specs == build_specs(param_template(cfg),
                                   ZamplingConfig(**ZC)).specs
    f32 = 0
    for p in zs.dense_paths:
        t, want = state["dense"][p], np.asarray(jstate["dense"][p])
        assert str(t.dtype).split(".")[-1] == str(want.dtype), p
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            f32 += 1
            np.testing.assert_array_equal(t.numpy(), want)
    if jcfg.ssm is not None or jcfg.moe is not None:
        assert f32 > 0  # A_log, D, dt_bias, or the router
    for p in zs.specs:
        np.testing.assert_array_equal(state["scores"][p].numpy(),
                                      np.asarray(jstate["scores"][p]))
