"""The port's primitives against the JAX package, on the same numpy inputs.

Integer streams must match exactly: hash words, QSpec fields, tensor
ids and leaf order, Q indices, mask bits, thresholds and encoded words.
Q values come from Box-Muller, whose log/cos differ in the last bits
between XLA and torch (up to 4.5e-5 on unit normals), so they are
compared with that tolerance scaled by sigma.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import downlink as jdl
from repro.configs.registry import get_arch as jget_arch
from repro.core import ZamplingConfig as JZC, build_specs as jbuild_specs
from repro.core import hashrng as jh, qspec as jq, sampling as js
from repro.models import build_model as jbuild_model
from repro_torch.comm import downlink as tdl
from repro_torch.configs import get_arch
from repro_torch.core import hashrng as th, qspec as tq, sampling as ts
from repro_torch.core.zampling import ZamplingConfig, build_specs
from repro_torch.models.model import param_template

BOX_MULLER_ATOL = 4.5e-5  # on unit normals, XLA vs torch log/cos

SHAPES = [(24, 40), (40, 24), (3, 40, 24), (2, 64, 96), (7, 5), (256, 512),
          (2, 256, 128), (1, 1000)]


def _u32(n, seed):
    return np.random.RandomState(seed).randint(
        0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _u32np(t):
    return t.numpy().astype(np.uint32)


class TestHash:
    def test_static_words_fold_identically(self):
        for words in [(0,), (1, 2), (0, 5, 0x10000), (2**32 - 1, 7, 3, 9)]:
            assert th.hash_u32(*words) == int(jh.hash_u32(*words))
        assert th.fmix32(0xDEADBEEF) == jh.fmix32(0xDEADBEEF)

    @pytest.mark.parametrize("pos", [0, 1, 2, 3])
    def test_traced_word_in_each_position(self, pos):
        a = _u32(4096, pos)
        words = [3, 11, 0x80000, 77]
        jw = list(words)
        tw = list(words)
        jw[pos] = jnp.asarray(a)
        tw[pos] = _t(a)
        ref = np.asarray(jh.hash_u32(*jw))
        got = _u32np(th.hash_u32(*tw))
        assert (ref == got).all()

    def test_two_traced_words_broadcast(self):
        a, b = _u32(64, 1), _u32(8, 2)
        ref = np.asarray(jh.hash_u32(5, jnp.asarray(a)[:, None],
                                     jnp.asarray(b)[None, :]))
        got = _u32np(th.hash_u32(5, _t(a)[:, None], _t(b)[None, :]))
        assert (ref == got).all()

    def test_uniform_exact_and_gaussian_close(self):
        a, b = _u32(200_000, 3), _u32(200_000, 4)
        ju = np.asarray(jh.u32_to_uniform(jnp.asarray(a)))
        tu = th.u32_to_uniform(_t(a)).numpy()
        assert (ju == tu).all()
        jg = np.asarray(jh.gaussian_from_u32(jnp.asarray(a), jnp.asarray(b)))
        tg = th.gaussian_from_u32(_t(a), _t(b)).numpy()
        np.testing.assert_allclose(tg, jg, rtol=0, atol=BOX_MULLER_ATOL)


class TestQSpec:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("kw", [dict(), dict(compression=4.0, d=4, window=64),
                                    dict(compression=8, d=8, seed=3)])
    def test_fields_equal(self, shape, kw):
        j = jq.make_qspec(9, shape, shape[-2], **kw)
        t = tq.make_qspec(9, shape, shape[-2], **kw)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.sigma == t.sigma

    @pytest.mark.parametrize("shape", [(3, 40, 24), (2, 64, 96), (256, 512)])
    def test_row_indices_exact_values_close(self, shape):
        kw = dict(compression=4.0, d=4, window=64)
        j = jq.make_qspec(5, shape, shape[-2], **kw)
        t = tq.make_qspec(5, shape, shape[-2], **kw)
        rows = np.arange(j.m)
        ji = np.asarray(jq.row_indices(j, jnp.asarray(rows)))
        ti = tq.row_indices(t, torch.from_numpy(rows)).numpy()
        assert (ji == ti).all()
        jv = np.asarray(jq.row_values(j, jnp.asarray(rows)))
        tv = tq.row_values(t, torch.from_numpy(rows)).numpy()
        np.testing.assert_allclose(tv, jv, rtol=0,
                                   atol=BOX_MULLER_ATOL * j.sigma)


class TestSampling:
    def test_mask_bits_exact(self):
        rng = np.random.RandomState(0)
        n = 8192
        # boundary probabilities included: 0, 1, below/above, and the
        # exact uniform values k*2^-24 where <= flips
        p = rng.rand(n).astype(np.float32)
        p[:6] = [0.0, 1.0, -0.5, 1.5, 2.0**-24, 1.0 - 2.0**-24]
        coords = np.arange(n)
        for step in (0, 7, 2**32 - 1):
            ju = jh.hash_u32(3, 4, js.MASK_CTR, jnp.uint32(step),
                             jnp.asarray(coords, jnp.uint32))
            tu = ts.mask_u32(3, 4, step, torch.from_numpy(coords))
            assert (np.asarray(ju) == _u32np(tu)).all()
            jb = np.asarray(js.sample_mask_hash(jnp.asarray(p), 3, 4, step))
            tb = th.bernoulli_u32(tu, torch.clamp(torch.from_numpy(p), 0, 1))
            assert (jb == tb.numpy()).all()

    @pytest.mark.parametrize("bits", [8, 16])
    def test_threshold_exact_over_alphabet(self, bits):
        q = np.arange(1 << bits)
        ref = np.asarray(js.quant_threshold_u24(jnp.asarray(q, jnp.uint32),
                                                bits))
        got = ts.quant_threshold_u24(torch.from_numpy(q), bits).numpy()
        assert (ref.astype(np.int64) == got).all()
        assert got[0] == 0 and got[-1] == 1 << 24

    @pytest.mark.parametrize("bits", [8, 16])
    def test_quantized_draw_exact(self, bits):
        rng = np.random.RandomState(bits)
        q = rng.randint(0, 1 << bits, size=4096)
        ref = np.asarray(js.sample_mask_qhash(jnp.asarray(q, jnp.uint32),
                                              bits, 1, 2, 99))
        u = ts.mask_u32(1, 2, 99, torch.arange(4096))
        got = ((u >> 8) < ts.quant_threshold_u24(torch.from_numpy(q), bits))
        assert (ref == got.numpy().astype(np.float32)).all()


class TestDownlink:
    @pytest.mark.parametrize("codec", ["u8", "u16"])
    @pytest.mark.parametrize("word", [0, 3, 2**31 + 5])
    def test_encoded_words_exact(self, codec, word):
        spec = jq.make_qspec(6, (40, 96), 40, compression=4.0, d=4, window=64)
        tspec = tq.make_qspec(6, (40, 96), 40, compression=4.0, d=4, window=64)
        rng = np.random.RandomState(word % 1000)
        s = (rng.rand(spec.n) * 1.4 - 0.2).astype(np.float32)
        s[:4] = [0.0, 1.0, 0.5, 1.0 / 255]
        jw = np.asarray(jdl.get_codec(codec).encode(spec, jnp.asarray(s),
                                                    js.as_word(np.uint32(word))))
        tw = tdl.encode(codec, tspec, torch.from_numpy(s), word)
        assert tw.dtype == {"u8": torch.uint8, "u16": torch.uint16}[codec]
        assert (jw.astype(np.int64)
                == tw.view(torch.int16 if codec == "u16" else torch.uint8)
                .to(torch.int64).numpy() % (1 << (8 if codec == "u8" else 16))
                ).all()
        jd = np.asarray(jdl.get_codec(codec).decode(spec, jnp.asarray(jw)))
        assert (jd == tdl.decode(codec, tspec, tw).numpy()).all()

    def test_f32_identity_and_packed_later(self):
        s = torch.rand(16)
        assert tdl.encode("f32", None, s, 0) is s
        with pytest.raises(NotImplementedError):
            tdl.get_codec("packed4")
        with pytest.raises(ValueError):
            tdl.get_codec("nope")


class TestBuildSpecs:
    @pytest.mark.parametrize("min_size", [1024, 65536])
    def test_reduced_qwen2_ids_and_order(self, min_size):
        cfg = jget_arch("qwen2-0.5b").reduced()
        jmodel = jbuild_model(cfg)
        tmpl = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
        jz = jbuild_specs(tmpl, JZC(compression=8, d=8, min_size=min_size))
        tz = build_specs(param_template(get_arch("qwen2-0.5b").reduced()),
                         ZamplingConfig(compression=8, d=8, min_size=min_size))
        assert list(jz.specs) == list(tz.specs)
        assert jz.dense_paths == tz.dense_paths
        for path in jz.specs:
            assert (dataclasses.asdict(jz.specs[path])
                    == dataclasses.asdict(tz.specs[path])), path
        jflat = jax.tree_util.tree_flatten_with_path(tmpl)[0]
        assert [tuple(l.shape) for _, l in jflat] == [
            l.shape for l in tz.template.values()]

    def test_flat_and_nested_templates_agree(self):
        nested = {"b": {"x": (64, 64), "a": (8,)}, "a": (128, 32)}
        flat = {"b/x": (64, 64), "a": (128, 32), "b/a": (8,)}
        cfg = ZamplingConfig(min_size=1024)
        assert build_specs(nested, cfg).specs == build_specs(flat, cfg).specs
        assert build_specs(flat, cfg).specs["b/x"].tensor_id == 2
