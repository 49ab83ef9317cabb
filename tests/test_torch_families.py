"""The model families of the port against the JAX package.

Every arch of the registry at ``reduced()`` size (f32), with the same
numpy inputs on both sides: the configs, the parameter template (paths,
shapes, dtypes, hence tensor ids) and spec set, ``make_batch``'s arrays,
the K-client forward, aux loss, loss and weight gradients, two decode
steps a family, the MoE dispatch's integers, the blockwise attention,
bf16 SSM and MoE blocks, the SSD's gradient where JAX's overflows, and
the standard train step.  ``test_torch_families_train.py`` holds the
federated LM rounds, the zampling train step and ``convert``.

Tolerances (measured on the CPU, float32 sums in other orders): logits
within 1.6e-6 of their largest magnitude, weight gradients within
3.3e-6 of a leaf's largest, losses within 4e-7 relative; held here at
1e-5, 2e-5 and 1e-5.  Decoding keeps JAX's values within 1e-5.  At
bf16, counted in ulps of the output's largest magnitude: an SSM block's
outputs differ from JAX's by at most 1 (a fifth of its elements by more
than an ulp of their own: XLA's CPU backend may keep intermediates in
f32 across the casts at which torch rounds to bf16), a MoE block's by
0; the bounds below are 2 and 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import (active_param_count_estimate as jactive,
                                param_count_estimate as jcount)
from repro.core import zampling as jz
from repro.launch import input_specs as jinp
from repro.models import flash as jflash, moe as jmoe, ssm as jssm
from repro.models import attention as jattn
from repro.models.model import build_model as jbuild, loss_fn as jloss
from repro.optim import sgd as jsgd
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.configs import (ARCHS, SHAPES, InputShape, get_arch,
                                 get_shape)
from repro_torch.configs.base import (active_param_count_estimate,
                                      param_count_estimate)
from repro_torch.core.zampling import (ZamplingConfig, build_specs, flatten,
                                       init_state)
from repro_torch.launch import input_specs
from repro_torch.models import attention as tattn, flash, moe, ssm
from repro_torch.models.model import (build_model, forward_with_aux,
                                      init_dense, loss_fn, param_template)
from repro_torch.optim import sgd
from repro_torch.train import steps
from _torch_families_common import (_BUILT, K, ZC, _built, _jflat, _nest,
                                     _params, _rel_of_max)

ARCH_IDS = sorted(ARCHS)
SMOKE = InputShape("smoke", seq_len=32, global_batch=2, kind="train")
LOGITS_RTOL_OF_MAX = 1e-5  # measured within 1.6e-6 of the largest logit
GRAD_RTOL_OF_MAX = 2e-5  # measured within 3.3e-6 of a leaf's largest
LOSS_RTOL = 1e-5  # measured within 4e-7
DECODE_ATOL = 1e-5
SSM_BF16_ULPS = 2  # measured 1
MOE_BF16_ULPS = 1  # measured 0
STEP_LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# configs, templates, specs, batches
# ---------------------------------------------------------------------------

def test_registry_is_the_jax_packages():
    assert list(ARCHS) == list(jreg.ARCHS)
    for name, cfg in ARCHS.items():
        jcfg = jreg.ARCHS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), name
        assert (dataclasses.asdict(cfg.reduced())
                == dataclasses.asdict(jcfg.reduced())), name
        assert param_count_estimate(cfg) == jcount(jcfg)
        assert active_param_count_estimate(cfg) == jactive(jcfg)
        for shape in SHAPES:
            assert cfg.supports_shape(shape) == jcfg.supports_shape(shape)
    assert {n: dataclasses.asdict(s) for n, s in SHAPES.items()} == {
        n: dataclasses.asdict(s) for n, s in jreg.SHAPES.items()}
    assert get_shape("train_4k").seq_len == 4096
    with pytest.raises(KeyError, match="unknown shape"):
        get_shape("nope")
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("nope")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_template_specs_and_batch_are_the_jax_packages(arch):
    for reduce in (True, False):
        cfg = get_arch(arch).reduced() if reduce else get_arch(arch)
        jcfg = jreg.get_arch(arch)
        jcfg = jcfg.reduced() if reduce else jcfg
        jt = jax.eval_shape(jbuild(jcfg).init_params, jax.random.PRNGKey(0))
        flat_j = _jflat(jt)
        tt = dict(flatten(param_template(cfg)))
        assert list(tt) == list(flat_j)  # the order fixes the tensor ids
        for p, leaf in tt.items():
            assert leaf.shape == tuple(flat_j[p].shape), p
            assert leaf.dtype == str(flat_j[p].dtype), p
        zs = convert.zspecs_from_jax(jz.build_specs(jt, jz.ZamplingConfig(
            **ZC)))  # raises on any QSpec field that differs
        assert zs.specs == build_specs(param_template(cfg),
                                       ZamplingConfig(**ZC)).specs
        shape = SMOKE if reduce else InputShape("t", 8, 1, "train")
        for kind in ("train", "decode"):
            sh = dataclasses.replace(shape, kind=kind)
            jsh = jreg.InputShape(sh.name, sh.seq_len, sh.global_batch, kind)
            specs = input_specs.input_specs(cfg, sh)
            jspecs = jinp.input_specs(jcfg, jsh)
            assert list(specs) == list(jspecs)
            got = input_specs.make_batch(cfg, sh, seed=3, device="cpu")
            want = jinp.make_batch(jcfg, jsh, seed=3)
            for name, t in got.items():
                w = np.asarray(want[name])
                assert tuple(t.shape) == specs[name].shape == w.shape
                if t.dtype == torch.bfloat16:  # by bits
                    np.testing.assert_array_equal(
                        t.view(torch.int16).numpy(), w.view(np.int16))
                else:
                    assert str(t.dtype).split(".")[-1] == str(w.dtype)
                    np.testing.assert_array_equal(t.numpy(), w)


# ---------------------------------------------------------------------------
# forward, aux loss, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_loss_and_gradients_against_jax(arch):
    cfg, jcfg, jm = _built(arch)
    params = _params(cfg)
    bs = [input_specs.make_batch(cfg, SMOKE, seed=k, device="cpu")
          for k in range(K)]
    jbs = [jinp.make_batch(jcfg, jreg.InputShape("smoke", 32, 2, "train"),
                           seed=k) for k in range(K)]
    stacked = {p: jnp.asarray(v) for p, v in params.items()}
    jb = {n: jnp.stack([b[n] for b in jbs]) for n in jbs[0]}

    def one(pk, bk):
        pk = _nest(pk)
        logits, aux = jm.forward(pk, bk)
        loss, g = jax.value_and_grad(lambda pp: jloss(jm, pp, bk))(pk)
        return logits, aux["aux_loss"], loss, _jflat(g)

    jlog, jaux, jl, jg = jax.jit(jax.vmap(one))(stacked, jb)
    tb = {n: torch.stack([b[n] for b in bs]) for n in bs[0]}
    tp = {p: torch.from_numpy(v).requires_grad_(True)
          for p, v in params.items()}
    logits, aux = forward_with_aux(cfg, tp, tb)
    assert logits.shape == (K, 2, 32, cfg.padded_vocab)
    assert _rel_of_max(logits.detach().numpy(),
                       np.asarray(jlog)) <= LOGITS_RTOL_OF_MAX
    np.testing.assert_allclose(aux["aux_loss"].detach().numpy(),
                               np.asarray(jaux), rtol=1e-5, atol=1e-9)
    if cfg.moe is not None:
        assert (aux["aux_loss"] > 0).all()
    tl = loss_fn(cfg, tp, tb)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=LOSS_RTOL)
    # a VLM's stubbed embeddings leave its token table unused: JAX's
    # gradient there is zeros
    grads = torch.autograd.grad(tl.sum(), list(tp.values()),
                                allow_unused=True)
    for p, g in zip(tp, grads):
        g = torch.zeros_like(tp[p]) if g is None else g
        err = _rel_of_max(g.numpy(), np.asarray(jg[p]))
        assert err <= GRAD_RTOL_OF_MAX, (p, err)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def _decode_pair(arch, steps_, seq_len, seed=0, window=None):
    """Port and JAX decode logits over ``steps_`` tokens from JAX's
    init_params (both models built with ``window_override=window``), and
    the port's params and tokens."""
    cfg, jcfg, jm = _built(arch)
    if window is not None:
        jm = jbuild(jcfg, window_override=window)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    params = {p: torch.from_numpy(np.asarray(v)) for p, v in
              _jflat(jp).items()}
    toks = np.random.RandomState(seed + 1).randint(0, cfg.vocab,
                                                   (2, steps_)).astype(
        np.int32)
    model = build_model(cfg, window_override=window)
    cache = model.init_cache(params, 2, seq_len)
    jcache = jm.init_cache(jp, 2, seq_len)
    jstep = jax.jit(jm.decode_step)
    got, want = [], []
    for t in range(steps_):
        lg, cache = model.decode_step(
            params, cache, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        jlg, jcache = jstep(jp, jcache, {"tokens": jnp.asarray(
            toks[:, t:t + 1])})
        assert lg.dtype == torch.float32
        got.append(lg[:, 0].numpy())
        want.append(np.asarray(jlg)[:, 0])
    return np.stack(got, 1), np.stack(want, 1), params, toks, cfg


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b", "mamba2-1.3b",
                                  "zamba2-7b", "seamless-m4t-medium"])
def test_two_decode_steps_against_jax(arch):
    got, want, _, _, cfg = _decode_pair(arch, 2, 16)
    assert got.shape == (2, 2, cfg.padded_vocab)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=DECODE_ATOL)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_ssm_and_hybrid_decode_equal_their_forward(arch):
    got, want, params, toks, cfg = _decode_pair(arch, 16, 16, seed=1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=DECODE_ATOL)
    full = forward_with_aux(cfg, {p: v[None] for p, v in params.items()},
                            torch.from_numpy(toks)[None])[0][0]
    np.testing.assert_allclose(got, full.numpy(), rtol=1e-4, atol=1e-4)


def test_hybrid_with_a_remainder_group():
    """Three mamba layers at attn_every 2: the shared block runs before
    the group and before the remainder, its KV cache twice."""
    cfg = dataclasses.replace(get_arch("zamba2-7b").reduced(), n_layers=3)
    jcfg = dataclasses.replace(jreg.get_arch("zamba2-7b").reduced(),
                               n_layers=3)
    _BUILT["zamba2-3l"] = (cfg, jcfg, jbuild(jcfg))
    got, want, params, toks, cfg = _decode_pair("zamba2-3l", 16, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=DECODE_ATOL)
    assert build_model(cfg).init_cache(params, 2, 16).kv.k.shape[0] == 2
    full = forward_with_aux(cfg, {p: v[None] for p, v in params.items()},
                            torch.from_numpy(toks)[None])[0][0]
    np.testing.assert_allclose(got, full.numpy(), rtol=1e-4, atol=1e-4)


def test_dense_decoder_decodes_one_way_at_any_window():
    """A window override keeps the dense decoder on its float32
    ``decode_layers`` path (float32 cache), and its ring buffer wraps
    past the overridden window as JAX's does."""
    window = 4
    cfg = get_arch("qwen2-0.5b").reduced()
    cache = build_model(cfg, window_override=window).init_cache({}, 2, 16,
                                                                device="cpu")
    assert cache.k.dtype == torch.float32 and cache.k.shape[2] == window
    got, want, _, _, _ = _decode_pair("qwen2-0.5b", window + 6, 16,
                                      window=window)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=DECODE_ATOL)


def test_mixtral_ring_buffer_past_the_window():
    """Decoding past the window against JAX's, step by step.  (Not
    against the forward: a decode step routes B tokens at a capacity of
    int(1.25·B·k/E) slots an expert, the forward all B·S, so their MoE
    drops differ, in JAX too.)"""
    cfg = get_arch("mixtral-8x7b").reduced()
    n = cfg.window + 6  # the cache (min(seq, window) slots) wraps
    got, want, _, _, _ = _decode_pair("mixtral-8x7b", n, n)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=DECODE_ATOL)


# ---------------------------------------------------------------------------
# the MoE dispatch, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "ties", "drops"])
def test_moe_dispatch_integers_equal_jaxs(case):
    mcfg = get_arch("olmoe-1b-7b").reduced().moe
    rng = np.random.RandomState(5)
    G, D, E = 24, 16, mcfg.num_experts
    xt = rng.randn(G, D).astype(np.float32)
    router = rng.randn(D, E).astype(np.float32)
    if case == "ties":  # every probability equal: the lower index wins
        router[:] = 0.0
    if case == "drops":  # every token prefers expert 2: capacity drops
        xt = np.abs(xt)
        router[:, 2] = 5.0
    d, c, probs, sel = moe._group_dispatch(torch.from_numpy(xt),
                                           torch.from_numpy(router), mcfg)
    jd, jc, jprobs, jsel = jmoe._group_dispatch(jnp.asarray(xt),
                                                jnp.asarray(router), mcfg)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(c.numpy() > 0, np.asarray(jc) > 0)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-5,
                               atol=1e-12)
    C = max(1, int(mcfg.capacity_factor * G * mcfg.top_k / E))
    assert d.shape == (G, E, C)
    kept = int(d.sum())
    if case == "ties":
        picks = sel.numpy().argmax(-1)
        assert (picks == np.arange(mcfg.top_k)).all()
    if case == "drops":
        assert kept < G * mcfg.top_k  # some picks found the buffer full
    else:
        assert kept <= G * mcfg.top_k


@pytest.mark.parametrize("T", [24, 2048 * 2, 2048 + 8])
def test_moe_groups_and_single_group_rule(T):
    """T a multiple of GROUP_SIZE: T/G groups; otherwise one group."""
    mcfg = get_arch("mixtral-8x7b").reduced().moe
    D = 8
    rng = np.random.RandomState(T)
    x = rng.randn(1, T, D).astype(np.float32)
    p = {"router": rng.randn(D, mcfg.num_experts).astype(np.float32) * 0.3,
         "gate": rng.randn(mcfg.num_experts, D, 4).astype(np.float32) * 0.3,
         "up": rng.randn(mcfg.num_experts, D, 4).astype(np.float32) * 0.3,
         "down": rng.randn(mcfg.num_experts, 4, D).astype(np.float32) * 0.3}
    out, aux = moe.moe_block({k: torch.from_numpy(v)[None]
                              for k, v in p.items()},
                             torch.from_numpy(x)[None], mcfg)
    jout, jaux = jmoe.moe_block({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), mcfg)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux[0]), float(jaux), rtol=1e-5)


# ---------------------------------------------------------------------------
# blockwise attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["causal", "window", "cross", "gqa"])
def test_blockwise_attention_and_gradient_against_jax(kind):
    rng = np.random.RandomState(7)
    B, Sq, Sk, H, KV, hd = 2, 32, 32, 4, 4, 8
    causal, window = True, None
    if kind == "window":
        window = 11
    if kind == "cross":
        Sq, causal = 16, False
    if kind == "gqa":
        KV = 2
    q = rng.randn(B, Sq, H, hd).astype(np.float32)
    k = rng.randn(B, Sk, KV, hd).astype(np.float32)
    v = rng.randn(B, Sk, KV, hd).astype(np.float32)
    w = rng.randn(B, Sq, H, hd).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=8, k_chunk=8)

    def jf(q_, k_, v_):
        return jnp.sum(jflash.blockwise_attention(q_, k_, v_, **kw) * w)

    jval, jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jout = jflash.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = flash.blockwise_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    val = torch.sum(out * torch.from_numpy(w))
    grads = torch.autograd.grad(val, (tq, tk, tv))
    scale = float(np.abs(np.asarray(jout) * w).sum())  # of the summed terms
    np.testing.assert_allclose(float(val), float(jval), rtol=0,
                               atol=1e-5 * scale)
    for g, jg in zip(grads, jgrads):
        assert _rel_of_max(g.numpy(), np.asarray(jg)) <= 1e-5


def test_self_attention_takes_the_blockwise_form_at_4096():
    """One head of width 8 over 4096 tokens, through the threshold, with
    and without a window, against JAX's self_attention and the port's
    direct form."""
    S, D = tattn.FLASH_THRESHOLD, 8
    rng = np.random.RandomState(8)
    p = {w: rng.randn(D, D).astype(np.float32) * 0.3
         for w in ("wq", "wk", "wv", "wo")}
    x = rng.randn(1, S, D).astype(np.float32)
    pos = np.arange(S)[None]
    for window in (None, 300):
        dims = tattn.AttnDims(n_heads=1, n_kv=1, head_dim=D, window=window)
        jdims = jattn.AttnDims(n_heads=1, n_kv=1, head_dim=D, window=window)
        want = np.asarray(jattn.self_attention(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jdims,
            jnp.asarray(pos)))
        tp = {k: torch.from_numpy(v)[None] for k, v in p.items()}
        got = tattn.self_attention(tp, torch.from_numpy(x)[None], dims,
                                   torch.from_numpy(pos))[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
        # the direct form on the same projections
        q, k, v = (torch.from_numpy(x @ p[w]).reshape(1, S, 1, D)
                   for w in ("wq", "wk", "wv"))
        q, k, v = tattn.finish_qkv({}, q.reshape(1, S, D), k.reshape(1, S, D),
                                   v.reshape(1, S, D), dims,
                                   torch.from_numpy(pos))
        qi = torch.arange(S)[:, None]
        ki = torch.arange(S)[None, :]
        mask = torch.where(ki > qi, tattn.NEG_INF, 0.0)
        if window is not None:
            mask = torch.where(ki <= qi - window, tattn.NEG_INF, mask)
        direct = tattn._sdpa_rows(q, k, v, mask[None, None], 1)
        direct = direct.reshape(1, S, D) @ torch.from_numpy(p["wo"])
        np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# bf16 blocks
# ---------------------------------------------------------------------------

def _ulps(got: torch.Tensor, want) -> float:
    """Largest difference in bf16 ulps of the reference's largest
    magnitude."""
    w = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    ulp = 2.0 ** (np.floor(np.log2(float(w.abs().max()))) - 7)
    return float((got.float() - w).abs().max()) / ulp


def test_bf16_ssm_block_against_jax():
    cfg = get_arch("mamba2-1.3b").reduced()
    sd = ssm.ssm_dims(cfg.d_model, cfg.ssm)
    jsd = jssm.ssm_dims(cfg.d_model,
                        jreg.get_arch("mamba2-1.3b").reduced().ssm)
    jp = jssm.init_ssm_params(jax.random.PRNGKey(3), jsd, jnp.bfloat16)
    rng = np.random.RandomState(3)
    u = jnp.asarray(rng.randn(2, 32, cfg.d_model), jnp.bfloat16)
    want = jax.jit(lambda pp, uu: jssm.ssm_block(pp, uu, jsd))(jp, u)
    tp = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)[None]
        for k, v in jp.items()}
    for k in ("A_log", "D", "dt_bias"):
        assert tp[k].dtype == torch.float32
    tu = torch.from_numpy(np.asarray(u.astype(jnp.float32))).to(
        torch.bfloat16)[None]
    got = ssm.ssm_block(tp, tu, sd)[0]
    assert got.dtype == torch.bfloat16
    assert _ulps(got, want) <= SSM_BF16_ULPS


def test_bf16_moe_block_against_jax():
    mcfg = get_arch("olmoe-1b-7b").reduced().moe
    jp = jmoe.init_moe_params(jax.random.PRNGKey(4), 64, mcfg, jnp.bfloat16)
    rng = np.random.RandomState(4)
    x = jnp.asarray(rng.randn(2, 16, 64), jnp.bfloat16)
    want, jaux = jax.jit(lambda pp, xx: jmoe.moe_block(pp, xx, mcfg))(jp, x)
    tp = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)[None]
        for k, v in jp.items()}
    assert tp["router"].dtype == torch.float32
    got, aux = moe.moe_block(tp, torch.from_numpy(np.asarray(
        x.astype(jnp.float32))).to(torch.bfloat16)[None], mcfg)
    assert _ulps(got[0], want) <= MOE_BF16_ULPS
    np.testing.assert_allclose(float(aux[0]), float(jaux), rtol=1e-5)


def test_ssd_gradient_stays_finite_where_jaxs_overflows():
    """A chunk whose decay passes e^88: JAX's ``where(tri, exp(seg), 0)``
    overflows above the diagonal, and the where's zero gradient times
    exp's inf makes its gradient NaN (the reduced mamba2's round at
    sequence 128 of the LM entry point's settings loses its loss so).
    The port exponentiates the kept entries only: the same forward, a
    finite gradient."""
    cfg = get_arch("mamba2-1.3b").reduced()
    sd = ssm.ssm_dims(cfg.d_model, cfg.ssm)
    jsd = jssm.ssm_dims(cfg.d_model,
                        jreg.get_arch("mamba2-1.3b").reduced().ssm)
    jp = dict(jssm.init_ssm_params(jax.random.PRNGKey(6), jsd, jnp.float32))
    jp["A_log"] = jnp.full_like(jp["A_log"], np.log(16.0))
    jp["dt_bias"] = jnp.full_like(jp["dt_bias"], 6.0)  # 16 steps of -96
    rng = np.random.RandomState(6)
    u = rng.randn(1, 16, cfg.d_model).astype(np.float32)
    w = rng.randn(1, 16, cfg.d_model).astype(np.float32)
    jval, jgrad = jax.jit(jax.value_and_grad(
        lambda pp: jnp.sum(jssm.ssm_block(pp, jnp.asarray(u), jsd) * w)))(jp)
    assert not all(bool(jnp.isfinite(g).all()) for g in jgrad.values())
    tp = {k: torch.from_numpy(np.asarray(v))[None].clone().requires_grad_(
        True) for k, v in jp.items()}
    out = ssm.ssm_block(tp, torch.from_numpy(u)[None], sd)
    np.testing.assert_allclose(
        out[0].detach().numpy(), np.asarray(jax.jit(
            lambda pp: jssm.ssm_block(pp, jnp.asarray(u), jsd))(jp)),
        rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad((out * torch.from_numpy(w)[None]).sum(),
                                list(tp.values()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    # where JAX's gradient is finite, the port's equals it
    for (k, g) in zip(tp, grads):
        jg = np.asarray(jgrad[k])
        ok = np.isfinite(jg)
        if ok.all():
            np.testing.assert_allclose(g[0].numpy(), jg, rtol=1e-4,
                                       atol=1e-4 * np.abs(jg).max())


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------

def test_standard_train_step_against_jax():
    cfg, jcfg, jm = _built("mamba2-1.3b")
    params = {p: v[0] for p, v in _params(cfg, seed=5, k=1).items()}
    toks = np.random.RandomState(6).randint(0, cfg.vocab, (2, 2, 17)).astype(
        np.int32)
    jstep = jax.jit(jsteps.make_train_step(jm, jsgd(0.05)))
    jst = jsteps.init_train_state(_nest({p: jnp.asarray(v)
                                         for p, v in params.items()}),
                                  jsgd(0.05))
    st = steps.init_train_state({p: torch.from_numpy(v)
                                 for p, v in params.items()}, sgd(0.05))
    tstep = steps.make_train_step(build_model(cfg), sgd(0.05))
    for t in range(2):
        b = {"tokens": toks[t, :, :-1], "labels": toks[t, :, :-1]}
        jst, jm_ = jstep(jst, {n: jnp.asarray(v) for n, v in b.items()})
        st, m = tstep(st, {n: torch.from_numpy(v) for n, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=LOSS_RTOL)
    jflat = _jflat(jst.trainable)
    for p, v in st.trainable.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jflat[p]), rtol=0,
                                   atol=1e-6)
