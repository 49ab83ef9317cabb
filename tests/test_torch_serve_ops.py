"""The port's streamed serve ops against the JAX package's.

Same numpy scores, activations and draw words through both packages at
narrow widths.  JAX runs its serve ops as tests/test_serve.py does:
``impl="chunked"``, and the Pallas kernel in interpret mode.

Tolerance: rtol = atol = 1e-4.  The Q values come from Box-Muller,
whose log/cos differ in the last bits between XLA and torch (up to
4.5e-5 on unit normals), and XLA's dot sums a tile in its own order; the
mask bits, which decide which terms exist at all, match exactly.
Inside the port, matvec equals matmul at B=1 and a batch row equals its
own B=1 call, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.downlink import get_codec as jget_codec
from repro.core.qspec import make_qspec as jmake_qspec
from repro.core.sampling import as_word
from repro.kernels import ops as jops
from repro_torch.comm.downlink import get_codec
from repro_torch.core.qspec import make_qspec, row_indices, row_values
from repro_torch.core.sampling import mask_u32, quant_threshold_u24
from repro_torch.kernels import ops, qz_decode

RTOL = ATOL = 1e-4
CODECS = ("f32", "u8", "u16")
SHAPES = [(64, 48), (2, 64, 96)]
STEP = 5


def _specs(shape, tid=11):
    kw = dict(compression=4.0, d=4, window=64)
    return (jmake_qspec(tid, shape, shape[-2], **kw),
            make_qspec(tid, shape, shape[-2], **kw))


def _words(codec, jspec, tspec, seed=0):
    s = np.random.RandomState(seed).rand(jspec.n).astype(np.float32) * 1.2 - 0.1
    jc, tc = jget_codec(codec), get_codec(codec)
    if jc.quantized:
        return (jc.encode(jspec, jnp.asarray(s), as_word(3)),
                tc.encode(tspec, torch.from_numpy(s), 3), jc.bits)
    return jnp.asarray(s), torch.from_numpy(s), None


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("codec", CODECS)
def test_matmul_matches_jax(shape, codec):
    jspec, tspec = _specs(shape)
    jw, tw, qbits = _words(codec, jspec, tspec)
    X = _x(3, shape[-2])
    for g in range(shape[0] if len(shape) == 3 else 1):
        ref = np.asarray(jops.serve_matmul(jspec, jw, as_word(STEP),
                                           jnp.asarray(X), group=g,
                                           qbits=qbits, impl="chunked"))
        got = ops.serve_matmul(tspec, tw, STEP, torch.from_numpy(X), group=g,
                               qbits=qbits)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("codec", CODECS)
def test_matvec_matches_jax_pallas(codec):
    jspec, tspec = _specs((2, 64, 96), tid=4)
    jw, tw, qbits = _words(codec, jspec, tspec, seed=2)
    x = _x(64, seed=3)
    ref = np.asarray(jops.serve_matvec(jspec, jw, as_word(STEP),
                                       jnp.asarray(x), group=1, qbits=qbits,
                                       impl="pallas"))
    got = ops.serve_matvec(tspec, tw, STEP, torch.from_numpy(x), group=1,
                           qbits=qbits)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("codec", CODECS)
def test_embed_rows_match_jax(codec):
    jspec, tspec = _specs((40, 24), tid=14)
    jw, tw, qbits = _words(codec, jspec, tspec, seed=6)
    tokens = np.asarray([[3, 0], [39, 7]], np.int32)
    ref = np.asarray(jops.serve_embed_rows(jspec, jw, as_word(2),
                                           jnp.asarray(tokens), qbits=qbits))
    got = ops.serve_embed_rows(tspec, tw, 2, torch.from_numpy(tokens),
                               qbits=qbits)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("codec", CODECS)
def test_matvec_is_matmul_at_b1_and_rows_are_batch_free(codec):
    jspec, tspec = _specs((2, 64, 96))
    _, tw, qbits = _words(codec, jspec, tspec, seed=4)
    X = torch.from_numpy(_x(4, 64, seed=5))
    full = ops.serve_matmul(tspec, tw, STEP, X, group=1, qbits=qbits)
    for b in range(4):
        one = ops.serve_matmul(tspec, tw, STEP, X[b:b + 1], group=1,
                               qbits=qbits)
        vec = ops.serve_matvec(tspec, tw, STEP, X[b], group=1, qbits=qbits)
        assert torch.equal(one[0], vec)
        assert torch.equal(full[b], vec)


def test_wrappers_on_cpu_run_the_plain_path():
    _, tspec = _specs((2, 64, 96))
    tw = get_codec("u8").encode(tspec, torch.rand(tspec.n), 0)
    X = torch.from_numpy(_x(2, 64))
    off = 64 * 96
    y = qz_decode.qz_sample_matmul(tspec, tw, STEP, X, row_offset=off,
                                   d_in=64, d_out=96, qbits=8)
    assert torch.equal(y, ops.serve_matmul(tspec, tw, STEP, X, group=1,
                                           qbits=8))
    v = qz_decode.qz_sample_matvec(tspec, tw, STEP, X[0], row_offset=off,
                                   d_in=64, d_out=96, qbits=8)
    assert torch.equal(v, y[0])
    assert {"qz_sample_matmul", "qz_sample_matvec"} <= set(qz_decode.LAUNCHES)
    assert not any(qz_decode.LAUNCHES.values())


def test_plain_tree_matches_explicit_block_sums():
    """The plain path's order is the canonical tree: per column, block
    partial sums (ascending rows, from 0.0) added in block order."""
    _, tspec = _specs((2, 64, 96))
    tw = get_codec("u8").encode(tspec, torch.rand(tspec.n), 1)
    x = torch.from_numpy(_x(64, seed=9))
    off = 64 * 96
    rows = off + torch.arange(64)[:, None] * 96 + torch.arange(96)
    W = ops.serve_edge_weights(tspec, tw, STEP, rows, 8)
    blk = ops.serve_block_of(tspec, rows, ops.SERVE_BM)
    ref = torch.zeros(96)
    for o in range(96):
        acc, part = torch.tensor(0.0), torch.tensor(0.0)
        for i in range(64):
            part = part + x[i] * W[i, o]
            if i == 63 or blk[i, o] != blk[i + 1, o]:
                acc, part = acc + part, torch.tensor(0.0)
        ref[o] = acc
    got = ops.serve_matvec(tspec, tw, STEP, x, group=1, qbits=8)
    assert torch.equal(got, ref)


def test_dispatch_rules(monkeypatch):
    _, tspec = _specs((64, 48))
    tw = get_codec("u8").encode(tspec, torch.rand(tspec.n), 0)
    X = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.serve_matmul(tspec, tw, 0, X, qbits=8, impl="cuda")
    with pytest.raises(ValueError, match="unknown serve impl"):
        ops.serve_matmul(tspec, tw, 0, X, qbits=8, impl="pallas")
    monkeypatch.setenv("REPRO_SERVE_IMPL", "cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.serve_matmul(tspec, tw, 0, X, qbits=8)
    monkeypatch.delenv("REPRO_SERVE_IMPL")
    with pytest.raises(ValueError, match="packed"):
        ops.serve_matmul(tspec, tw, 0, X, qbits=4)
    # a packed4 carry serves off its lanes, as the explicit weights of
    # its unpacked 4-bit words do through the same tree
    p4 = get_codec("packed4")
    lanes = p4.encode(tspec, torch.rand(tspec.n), 0)
    words = p4.wire_words(tspec, lanes)
    rows = torch.arange(tspec.m)
    coords = ((rows // tspec.rows_per_window)[:, None] * tspec.window
              + row_indices(tspec, rows))
    u = mask_u32(tspec.seed, tspec.tensor_id, 5, coords)
    prod = row_values(tspec, rows) * (
        (u >> 8) < quant_threshold_u24(words[coords], 4)).to(torch.float32)
    W = prod[:, 0]
    for k in range(1, tspec.d):
        W = W + prod[:, k]
    X = torch.from_numpy(_x(2, 64))
    got = ops.serve_matmul(tspec, lanes, 5, X, qbits=4, qpacked=True)
    assert torch.equal(got, ops.serve_resident_matmul(tspec, W, X))
    with pytest.raises(ValueError, match="must be"):
        ops.serve_matmul(tspec, tw.to(torch.int32), 0, X, qbits=8)
    assert ops.resolve_serve_impl(None, X) == "chunked"
