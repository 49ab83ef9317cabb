"""Federated zampling of a decoder LM in the port against the JAX package.

The JAX package's LM entry point (``launch/train.py``) runs
``federated_round`` over the dense decoder of ``models/model.py``;
here the port's (``repro_torch.launch.train``) at
``scaled(get_arch("qwen2-0.5b"), 0.01)``: 2 layers, d_model 64, one
head, d_ff 448, vocab 8192, with K=2 clients, E=2 local steps, batch 2,
sequence 16.  Inputs are seeded numpy arrays and explicit uint32 words.

Exact: the token stream, ``scaled()``, the parameter template (leaf
order, shapes, dtypes, so every tensor id), the spec set, the dense
leaves' layout, bf16 SGD and client means, a converted JAX state.
Allclose: the loss and its weight gradients on the same numpy
parameters (float32 sums in another order: measured within 2e-6 of a
leaf's largest gradient), and a round's loss, dense leaves and scores
(Box-Muller's log/cos differ between XLA and torch by up to 4.5e-5 on
a unit normal, so the weights are allclose; a mask bit drawn within
that rounding of its uniform can flip on one side, moving one
coordinate's client mean by 1/K).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import federated as jfed, zampling as jz
from repro.data import synthetic as jsyn
from repro.launch.train import scaled as jscaled
from repro.models import common as jcommon
from repro.models.model import build_model as jbuild_model
from repro.models.model import loss_fn as jloss_fn
from repro_torch import convert
from repro_torch.comm.protocol import mean0
from repro_torch.configs import get_arch
from repro_torch.core import federated as tfed
from repro_torch.core.zampling import (ZamplingConfig, build_specs, flatten,
                                       init_state)
from repro_torch.data import lm_token_batches
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models.model import (forward, init_dense, loss_fn,
                                      param_template)
from repro_torch.optim import sgd

SCALE = 0.01
K, E, B, S = 2, 2, 2, 16
ZC = dict(compression=8, d=8, min_size=4096)  # the JAX entry point's
GRAD_RTOL_OF_MAX = 2e-5  # measured within 2e-6 of a leaf's largest
# a round, measured: the loss equal in all printed digits, the dense
# leaves within 1.2e-7, no score differing
LOSS_RTOL = 1e-5
DENSE_ATOL = 1e-6  # dense leaves after E SGD steps at lr 0.05
MAX_FLIP_SHARE = 1e-3  # upload bits flipped by rounding, of all bits


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run beside other test processes,
    and torch's thread pools would only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(keys):
    return "/".join(str(getattr(k, "key", k)) for k in keys)


def _jflat(tree):
    return {_path(p): v for p, v in jax.tree_util.tree_flatten_with_path(
        tree)[0]}


def _nest(flat):
    out = {}
    for p, v in flat.items():
        node = out
        *heads, last = p.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


@pytest.fixture(scope="module")
def lm():
    cfg = ttrain.scaled(get_arch("qwen2-0.5b"), SCALE)
    jcfg = jscaled(jget_arch("qwen2-0.5b"), SCALE)
    model = jbuild_model(jcfg)
    jt = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    zs = build_specs(param_template(cfg), ZamplingConfig(**ZC))
    jzs = jz.build_specs(jt, jz.ZamplingConfig(**ZC))
    return dict(cfg=cfg, jcfg=jcfg, model=model, jt=jt, zs=zs, jzs=jzs)


def test_token_stream_is_the_jax_packages():
    a, b = lm_token_batches(8192, 6, 17, seed=3), jsyn.lm_token_batches(
        8192, 6, 17, seed=3)
    for _ in range(3):
        x, y = next(a), next(b)
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("scale", [0.01, 0.25, 1.0])
def test_scaled_config_and_template_are_the_jax_packages(scale):
    cfg = ttrain.scaled(get_arch("qwen2-0.5b"), scale)
    jcfg = jscaled(jget_arch("qwen2-0.5b"), scale)
    for f in ("n_layers", "d_model", "vocab", "n_heads", "n_kv", "head_dim",
              "d_ff", "qkv_bias", "dtype", "padded_vocab"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    jt = _jflat(jax.eval_shape(jbuild_model(jcfg).init_params,
                               jax.random.PRNGKey(0)))
    tt = dict(flatten(param_template(cfg)))
    assert list(tt) == list(jt)  # the flatten order fixes the tensor ids
    for p, leaf in tt.items():
        assert leaf.shape == tuple(jt[p].shape)
        assert leaf.dtype == str(jt[p].dtype)


def test_spec_set_and_dense_layout(lm):
    zs = convert.zspecs_from_jax(lm["jzs"])
    assert zs.specs == lm["zs"].specs
    assert zs.dense_paths == lm["zs"].dense_paths
    dense = init_dense(lm["cfg"], zs.dense_paths)
    real = _jflat(lm["model"].init_params(jax.random.PRNGKey(0)))
    for p in zs.dense_paths:  # norms and biases: no random draw
        np.testing.assert_array_equal(dense[p], np.asarray(real[p]))


def _params(cfg, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for p, leaf in flatten(param_template(cfg)):
        norm = "ln" in p or "norm" in p
        out[p] = (rng.randn(K, *leaf.shape) * (0.5 if norm else 0.05)
                  + (1.0 if norm else 0.0)).astype(np.float32)
    return out


def test_loss_and_weight_gradients_against_jax(lm):
    cfg, model = lm["cfg"], lm["model"]
    params = _params(cfg)
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (K, B, S + 1)
                                            ).astype(np.int32)
    jl, jg = [], []
    for k in range(K):
        pk = _nest({p: jnp.asarray(v[k]) for p, v in params.items()})
        batch = {"tokens": jnp.asarray(toks[k]), "labels": jnp.asarray(toks[k])}
        loss, g = jax.value_and_grad(lambda pp: jloss_fn(model, pp, batch))(pk)
        jl.append(float(loss))
        jg.append(_jflat(g))
    tp = {p: torch.from_numpy(v).requires_grad_(True)
          for p, v in params.items()}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    tl = loss_fn(cfg, tp, tb)
    assert tl.shape == (K,)
    np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=LOSS_RTOL)
    grads = torch.autograd.grad(tl.sum(), list(tp.values()))
    for p, g in zip(tp, grads):
        want = np.stack([jg[k][p] for k in range(K)])
        err = np.abs(g.numpy() - want).max() / np.abs(want).max()
        assert err <= GRAD_RTOL_OF_MAX, (p, err)
    jlogits = lm["model"].forward(_nest({p: jnp.asarray(v[0])
                                         for p, v in params.items()}),
                                  {"tokens": jnp.asarray(toks[0])})[0]
    logits = forward(cfg, {p: torch.from_numpy(v) for p, v in params.items()},
                     torch.from_numpy(toks).to(torch.int64))
    assert logits.shape == (K, B, S + 1, cfg.padded_vocab)
    np.testing.assert_allclose(logits[0].detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)


def test_chunked_cross_entropy_against_jax():
    rng = np.random.RandomState(2)
    T = tcommon.CE_CHUNK + 300  # two chunks, the second padded
    logits = rng.randn(1, T, 40).astype(np.float32)
    labels = rng.randint(0, 36, (1, T)).astype(np.int32)
    labels[0, :5] = -100  # ignored tokens
    want = float(jcommon.cross_entropy(jnp.asarray(logits[0]),
                                       jnp.asarray(labels[0]),
                                       num_classes=36))
    got = tcommon.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels).to(torch.int64),
                                num_classes=36, lead=1)
    np.testing.assert_allclose(got.numpy(), [want], rtol=1e-5)


def test_bf16_sgd_and_client_mean_are_jaxs():
    """Full width runs bf16 dense leaves: SGD's update is bf16(-lr) * g
    rounded to bf16 (a weakly typed Python float), and the client mean
    sums in f32 before the cast back, as ``jnp.mean`` does."""
    rng = np.random.RandomState(4)
    g = rng.randn(4, 3, 50).astype(np.float32)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    jgb = jnp.asarray(g).astype(jnp.bfloat16)
    upd, _ = sgd(0.05).update({"x": gb}, ())
    want = np.asarray((-0.05 * jgb).astype(jnp.float32))
    assert upd["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(upd["x"].float().numpy(), want)
    got = mean0(gb)
    assert got.dtype == torch.bfloat16
    wantm = jax.jit(lambda x: jnp.mean(x, axis=0))(jgb)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(wantm.astype(jnp.float32)))


def _state(zs, seed=0):
    rng = np.random.RandomState(seed)
    return ({p: rng.rand(s.n).astype(np.float32) for p, s in zs.specs.items()},
            init_dense(ttrain.scaled(get_arch("qwen2-0.5b"), SCALE),
                       zs.dense_paths))


@pytest.mark.parametrize("path", ["plan", "scatter"])
def test_one_lm_round_against_jax(lm, monkeypatch, path):
    """JAX's plain reference (``impl="ref"``) under ``REPRO_BWD_PLAN``,
    jitted, against the port's plain path under the same gate."""
    monkeypatch.setenv("REPRO_BWD_PLAN", path)
    zs, jzs, cfg = lm["zs"], lm["jzs"], lm["cfg"]
    scores, dense = _state(zs)
    toks = next(lm_token_batches(cfg.vocab, K * E * B, S + 1, seed=0)
                ).reshape(K, E, B, S + 1)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., :-1]}
    fc = dict(num_clients=K, local_steps=E, local_lr=0.05)
    key = 77
    state = init_state(zs, scores, dense, device="cpu")
    new, met = tfed.federated_round(zs, state,
                                    lambda prm, b: loss_fn(cfg, prm, b),
                                    batch, key, tfed.FederatedConfig(**fc),
                                    device="cpu")
    jstate = {"scores": {p: jnp.asarray(v) for p, v in scores.items()},
              "dense": {p: jnp.asarray(v) for p, v in dense.items()}}
    model = lm["model"]
    jnew, jmet = jax.jit(lambda s, b: jfed.federated_round(
        jzs, s, lambda prm, bb: jloss_fn(model, prm, bb), b, np.uint32(key),
        jfed.FederatedConfig(**fc)))(
        jstate, {n: jnp.asarray(v) for n, v in batch.items()})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    for p in zs.dense_paths:
        np.testing.assert_allclose(new["dense"][p].numpy(),
                                   np.asarray(jnew["dense"][p]), rtol=0,
                                   atol=DENSE_ATOL)
    # the scores are the K clients' mean masks: a flipped bit moves one
    # coordinate by 1/K, every other coordinate is exact
    differ = sum(int((new["scores"][p].numpy()
                      != np.asarray(jnew["scores"][p])).sum())
                 for p in zs.specs)
    assert differ <= MAX_FLIP_SHARE * K * zs.n_total
    for name in tfed.WIRE_METRIC_KEYS:
        assert met[name] == float(jmet[name])


def test_plan_and_scatter_rounds_agree_bitwise(lm, monkeypatch):
    zs, cfg = lm["zs"], lm["cfg"]
    scores, dense = _state(zs, 1)
    toks = next(lm_token_batches(cfg.vocab, K * E * B, S + 1, seed=5)
                ).reshape(K, E, B, S + 1)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., :-1]}
    out = []
    for path in ("plan", "scatter"):
        monkeypatch.setenv("REPRO_BWD_PLAN", path)
        out.append(tfed.federated_round(
            zs, init_state(zs, scores, dense, device="cpu"),
            lambda prm, b: loss_fn(cfg, prm, b), batch, 9,
            tfed.FederatedConfig(num_clients=K, local_steps=E,
                                 local_lr=0.05), device="cpu"))
    (a, ma), (b, mb) = out
    assert torch.equal(ma["loss"], mb["loss"])
    for part in ("scores", "dense"):
        for p in a[part]:
            assert torch.equal(a[part][p], b[part][p])


def test_bf16_template_carries_bf16_leaves(lm):
    """At full width the template is bf16: reconstructed leaves come out
    bf16 (cast outside the op, so the transpose sees f32), dense leaves
    stay bf16 through the round."""
    cfg = lm["cfg"].__class__(**{**lm["cfg"].__dict__, "dtype": "bfloat16"})
    zs = build_specs(param_template(cfg), ZamplingConfig(**ZC))
    scores, dense = _state(zs, 2)
    state = init_state(zs, scores, dense, device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in state["dense"].values())
    toks = next(lm_token_batches(cfg.vocab, K * E * B, S + 1, seed=6)
                ).reshape(K, E, B, S + 1)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., :-1]}
    new, met = tfed.federated_round(
        zs, state, lambda prm, b: loss_fn(cfg, prm, b), batch, 3,
        tfed.FederatedConfig(num_clients=K, local_steps=E, local_lr=0.05),
        device="cpu")
    assert np.isfinite(float(met["loss"]))
    assert all(v.dtype == torch.bfloat16 for v in new["dense"].values())
    assert all(v.dtype == torch.float32 for v in new["scores"].values())
    prog = tfed.mask_program(zs, tfed.FederatedConfig(num_clients=K))
    P = {p: torch.from_numpy(scores[p])[None].expand(K, -1).contiguous()
         .requires_grad_(True) for p in zs.specs}
    w = prog.weights(P, new["dense"], torch.tensor([1, 2]))
    assert all(w[p].dtype == torch.bfloat16 for p in zs.specs)


def test_convert_a_jax_lm_state(lm):
    """A JAX round state over a bf16 template: scores f32, dense leaves
    bf16 through f32 and back, exactly."""
    cfg = jget_arch("qwen2-0.5b").__class__(**{
        **lm["jcfg"].__dict__, "dtype": "bfloat16"})
    jt = jax.eval_shape(jbuild_model(cfg).init_params, jax.random.PRNGKey(0))
    jzs = jz.build_specs(jt, jz.ZamplingConfig(**ZC))
    rng = np.random.RandomState(3)
    jstate = {"scores": {p: jnp.asarray(rng.rand(s.n).astype(np.float32))
                         for p, s in jzs.specs.items()},
              "dense": {p: jnp.asarray(rng.randn(*s.shape).astype(np.float32)
                                       ).astype(jnp.bfloat16)
                        for p, s in _jflat(jt).items()
                        if p in jzs.dense_paths}}
    zs, st = convert.federated_state_from_jax(jzs, jstate, device="cpu")
    for p in zs.specs:
        np.testing.assert_array_equal(st["scores"][p].numpy(),
                                      np.asarray(jstate["scores"][p]))
    for p in zs.dense_paths:
        assert st["dense"][p].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            st["dense"][p].float().numpy(),
            np.asarray(jstate["dense"][p].astype(jnp.float32)))


def test_entry_point_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "run"
    argv = ["--device", "cpu", "--scale", str(SCALE), "--rounds", "2",
            "--clients", str(K), "--local-steps", str(E), "--batch", str(B),
            "--seq", str(S), "--out", str(out)]
    history = ttrain.main(argv)
    text = capsys.readouterr().out
    assert "[train] arch=qwen2-0.5b scaled:" in text
    assert "[round   0] loss=" in text and "[round   1] loss=" in text
    assert json.loads((out / "history.json").read_text()) == history
    assert len(history) == 2 and all(np.isfinite(history))
    # the same flags give the same run
    run = ttrain.build(ttrain.parser().parse_args(argv))
    assert ttrain.train(run) == history
