"""The port's model-axis ops (``kernels/qz_sharded.py``) against JAX's
and against the port's plain global op, one shard at a time in this
process (nothing spawns).

Against JAX's ``kernels/qz_sharded.py`` on a 4-device CPU mesh (entered
with ``jax.set_mesh``; ``tests/conftest.py`` forces the 4 devices), at
the ``shard_count=4`` cases of JAX's ``tests/test_sharding_major.py``:
each shard's draw bits (f32 probabilities, u8 words, packed4 lanes) by
bits against JAX's draw at the same global coordinates; each shard's
block of the fused draw's weights and its slice of the gradient (plan
and scatter) within the tolerances of ``test_torch_train_ops.py`` (XLA's
and torch's Box-Muller part by ulps): a K=3 batch, and one client on the
scatter (each JAX shard_map compiles anew, a few seconds a case).

Against the port's plain global op (``core.reconstruct``), by bits at
``ms`` in {2, 4, 8, 16}: the shards' blocks and slices concatenated,
for the explicit and drawn forwards (f32, u8, packed4), the backward
(plan in both orders, scatter) and the upload pack; and the ``kernels.ops`` dispatch on a model
``AxisGroup`` with its autograd backward.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import bitpack as jbp
from repro.core import qspec as jq, sampling as js
from repro.kernels import qz_sharded as jqs
from repro_torch.comm.downlink import get_codec
from repro_torch.comm.shardmap import AxisGroup
from repro_torch.core import qspec as tq
from repro_torch.core.reconstruct import grad_z_batched_ref
from repro_torch.kernels import ops, qz_sharded as qs
from test_torch_train_ops import BOX_MULLER_ATOL, SUM_RTOL

# JAX's shard_count=4 cases: (shape, major_axis, shard_count,
# compression, d, window)
JAX_CASES = [((8, 6, 16), 2, 4, 2.0, 4, 32), ((12, 10), 0, 4, 4.0, 5, 32)]
# ms up to 16, blocks with padding rows and without
PLAIN_CASES = [((64, 48), 1, 3.0, 4, 32), ((48, 40), 0, 3.0, 8, 32)]


@pytest.fixture
def route(request):
    """Set the backward gate for one test, restoring it after."""
    old = os.environ.get("REPRO_BWD_PLAN")
    os.environ["REPRO_BWD_PLAN"] = request.param
    yield request.param
    if old is None:
        del os.environ["REPRO_BWD_PLAN"]
    else:
        os.environ["REPRO_BWD_PLAN"] = old


def _specs(case):
    shape, a, sc, c, d, window = case
    kw = dict(compression=c, d=d, window=window, seed=3, major_axis=a,
              shard_count=sc)
    j, t = jq.make_qspec(0, shape, 16, **kw), tq.make_qspec(0, shape, 16,
                                                            **kw)
    assert t.shard_count == j.shard_count == sc
    return j, t, sc


def _mesh():
    return jax.set_mesh(jax.make_mesh((4,), ("model",)))


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _slices(x, ms):
    """x's last axis cut into ms equal slices."""
    per = x.shape[-1] // ms
    return [x[..., s * per:(s + 1) * per].contiguous() for s in range(ms)]


def _cat_blocks(spec, blocks, batched):
    return torch.cat(blocks, spec.major_axis + int(batched))


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("codec", ["f32", "u8", "packed4"])
@pytest.mark.parametrize("case", JAX_CASES)
def test_each_shards_draw_is_jaxs_by_bits(case, codec, K):
    """A shard's mask bits, drawn at global coordinates, against JAX's
    draw of the whole vector, sliced."""
    j, t, ms = _specs(case)
    rng = np.random.RandomState(K)
    p = rng.rand(K, t.n).astype(np.float32)
    steps = np.arange(20, 20 + K, dtype=np.uint32)
    c = get_codec(codec)
    if codec == "f32":
        operand = torch.from_numpy(p)
        want = np.stack([np.asarray(js.sample_mask_hash(
            jnp.asarray(p[k]), j.seed, j.tensor_id, jnp.uint32(steps[k])))
            for k in range(K)])
    else:
        operand = c.encode(t, torch.from_numpy(p), 3)
        words = c.wire_words(t, operand).numpy()
        if c.packed:
            np.testing.assert_array_equal(
                np.asarray(jbp.unpack_words(jnp.asarray(
                    operand.numpy().astype(np.uint32)), t.n, c.bits)), words)
        want = np.stack([np.asarray(js.sample_mask_qhash(
            jnp.asarray(words[k].astype(np.uint32)), c.bits, j.seed,
            j.tensor_id, jnp.uint32(steps[k]))) for k in range(K)])
    qbits = c.bits if c.quantized else None
    got = [qs.local_draw(t, o if K > 1 else o[0], steps if K > 1
                         else int(steps[0]), sid, ms, qbits, c.packed)
           for sid, o in enumerate(_slices(operand, ms))]
    got = torch.cat([g if K > 1 else g[None] for g in got], -1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case,K", [(JAX_CASES[0], 3)])
def test_each_shards_block_and_fused_draw_against_jax(case, K):
    """Blocks of the fused draw w = Q Bern(p) against JAX's sharded op
    (values within Box-Muller's ulps), and each port block by bits its
    explicit op (kernels 3 and 1) on its own drawn slice, which the draw
    test holds to JAX's bits."""
    j, t, ms = _specs(case)
    rng = np.random.RandomState(K + 1)
    z = rng.rand(K, t.n).astype(np.float32)
    steps = np.arange(5, 5 + K, dtype=np.uint32)
    with _mesh():
        if K == 1:
            jf = np.asarray(jqs.sharded_sample_reconstruct(
                j, jnp.asarray(z[0]), jnp.uint32(steps[0]), 4))[None]
        else:
            jf = np.asarray(jqs.sharded_sample_reconstruct_batched(
                j, jnp.asarray(z), jnp.asarray(steps), 4))
    zs = _slices(torch.from_numpy(z), ms)
    if K == 1:
        fused = [qs.sharded_sample_reconstruct(t, zl[0], int(steps[0]), s,
                                               ms)[None]
                 for s, zl in enumerate(zs)]
    else:
        fused = [qs.sharded_sample_reconstruct_batched(t, zl, steps, s, ms)
                 for s, zl in enumerate(zs)]
    tol = t.d * BOX_MULLER_ATOL * t.sigma + 1e-7
    np.testing.assert_allclose(_cat_blocks(t, fused, True).numpy(), jf,
                               rtol=SUM_RTOL, atol=tol)
    for s, zl in enumerate(zs):
        drawn = qs.local_draw(t, zl, steps, s, ms)
        want = (qs.sharded_reconstruct(t, drawn[0], s, ms)[None] if K == 1
                else qs.sharded_reconstruct_batched(t, drawn, s, ms))
        assert _same(fused[s], want)


@pytest.mark.parametrize("case,K,route", [(JAX_CASES[0], 3, "plan"),
                                          (JAX_CASES[1], 1, "scatter")],
                         indirect=["route"])
def test_each_shards_gradient_against_jax(case, K, route):
    j, t, ms = _specs(case)
    G = np.random.RandomState(K + 2).randn(K, *t.shape).astype(np.float32)
    with _mesh():
        if K == 1:
            jg = np.asarray(jqs.sharded_grad_z(j, jnp.asarray(G[0]), 4))[None]
        else:
            jg = np.asarray(jqs.sharded_grad_z_batched(j, jnp.asarray(G), 4))
    a, n = t.major_axis, t.shape[t.major_axis] // ms
    Gt = torch.from_numpy(G)
    parts = [(qs.sharded_grad_z(t, Gt[0].narrow(a, s * n, n), s, ms)[None]
              if K == 1 else
              qs.sharded_grad_z_batched(t, Gt.narrow(a + 1, s * n, n), s, ms))
             for s in range(ms)]
    q = _dense_q(t)
    g = np.abs(G).reshape(K, -1)
    tol = (BOX_MULLER_ATOL * t.sigma * (g @ (q != 0)) + SUM_RTOL
           * (g @ np.abs(q)) + 1e-7)
    excess = np.abs(torch.cat(parts, -1).numpy() - jg) - tol
    assert excess.max() <= 0, excess.max()


def _dense_q(spec):
    from repro_torch.core.reconstruct import materialize_q

    return materialize_q(spec).numpy()


def _plain_spec(case, ms):
    shape, a, c, d, window = case
    spec = tq.make_qspec(2, shape, shape[0], compression=c, d=d,
                         window=window, seed=5, major_axis=a, shard_count=ms,
                         align=ms)
    assert spec.shard_count == ms
    return spec


@pytest.mark.parametrize("ms", [2, 4, 8, 16])
@pytest.mark.parametrize("case", PLAIN_CASES)
def test_blocks_concatenated_are_the_plain_global_op(case, ms):
    """Every shard's forward block (explicit, drawn on f32, u8 and
    packed4 operands), gradient slice (both routes) and upload lanes,
    concatenated, equal the port's plain global op by bits."""
    spec = _plain_spec(case, ms)
    rng = np.random.RandomState(ms)
    K = 3
    P = torch.from_numpy(rng.rand(K, spec.n).astype(np.float32))
    steps = torch.tensor([3, 4, 5])
    Z = (P > 0.5).to(torch.float32)
    Z[0, ::3] = -0.0
    want = ops.reconstruct_batched(spec, Z)
    got = [qs.sharded_reconstruct_batched(spec, z, s, ms)
           for s, z in enumerate(_slices(Z, ms))]
    assert _same(_cat_blocks(spec, got, True), want)
    for codec in ("f32", "u8", "packed4"):
        c = get_codec(codec)
        q = c.encode(spec, P, 1) if c.quantized else P
        qbits = c.bits if c.quantized else None
        want = ops.sample_reconstruct_batched(spec, q, steps, qbits=qbits,
                                              qpacked=c.packed)
        got = [qs.sharded_sample_reconstruct_batched(
            spec, ql, steps, s, ms, qbits=qbits, qpacked=c.packed)
            for s, ql in enumerate(_slices(q, ms))]
        assert _same(_cat_blocks(spec, got, True), want), codec
    G = torch.from_numpy(rng.randn(K, *spec.shape).astype(np.float32))
    a, n = spec.major_axis, spec.shape[spec.major_axis] // ms
    for path in ("plan", "plan:slot", "scatter"):
        os.environ["REPRO_BWD_PLAN"] = path
        try:
            want = grad_z_batched_ref(spec, G)
            got = [qs.sharded_grad_z_batched(spec, G.narrow(a + 1, s * n, n),
                                             s, ms) for s in range(ms)]
        finally:
            del os.environ["REPRO_BWD_PLAN"]
        assert _same(torch.cat(got, -1), want), path
    if (spec.nw_loc * spec.window) % 32 == 0:
        want = ops.sample_pack_batched(spec, P, steps)
        got = [qs.sharded_sample_pack_batched(spec, p, steps, s, ms)
               for s, p in enumerate(_slices(P, ms))]
        assert torch.equal(torch.cat(got, -1), want)


@pytest.mark.parametrize("case", PLAIN_CASES[:2])
def test_ops_dispatch_a_sharded_spec_to_its_shard(case):
    """``kernels.ops`` on a model AxisGroup: a sharded spec's slice in,
    its block out, and the autograd backward its slice of Q^T g (kernels
    7, 1 forward; 5/2 backward at one client); a replicated spec takes
    the global op; ``model_size`` must agree with the handle."""
    ms = 4
    spec = _plain_spec(case, ms)
    rng = np.random.RandomState(9)
    p = torch.from_numpy(rng.rand(spec.n).astype(np.float32))
    g = torch.from_numpy(rng.randn(*spec.shape).astype(np.float32))
    want = ops.sample_reconstruct(spec, p.clone().requires_grad_(True), 7)
    want_g = grad_z_batched_ref(spec, g[None])[0]
    a, n = spec.major_axis, spec.shape[spec.major_axis] // ms
    for s, pl in enumerate(_slices(p, ms)):
        axis = AxisGroup(None, ms, s)
        x = pl.clone().requires_grad_(True)
        w = ops.sample_reconstruct(spec, x, 7, row_sharding=axis,
                                   model_size=ms)
        assert _same(w, want.detach().narrow(a, s * n, n))
        w.backward(g.narrow(a, s * n, n))
        nl = spec.nw_loc * spec.window
        assert _same(x.grad, want_g[s * nl:(s + 1) * nl])
    one = tq.make_qspec(1, (40, 24), 40, compression=4, window=32)
    z = torch.from_numpy(rng.rand(one.n).astype(np.float32))
    assert _same(ops.reconstruct(one, z, row_sharding=AxisGroup(None, 4, 1)),
                 ops.reconstruct(one, z))
    with pytest.raises(ValueError, match="row_sharding"):
        ops.reconstruct(spec, p, model_size=4)
    with pytest.raises(ValueError, match="spans"):
        ops.reconstruct(spec, _slices(p, ms)[0], model_size=2,
                        row_sharding=AxisGroup(None, 4, 0))
    with pytest.raises(ValueError, match="shard_count"):
        qs.sharded_reconstruct(spec, p[:10], 0, 2)


def test_what_the_shard_ops_refuse():
    """A packed slice that holds no whole lanes of words, an upload slice
    that holds no whole lanes of 32, a shard outside the axis."""
    spec = tq.make_qspec(0, (4, 4, 16), 16, compression=4.0, d=2, window=4,
                         major_axis=2, shard_count=4)
    assert spec.shard_count == 4 and spec.window == 4
    n_loc = spec.nw_loc * spec.window
    assert n_loc % 32
    q = torch.zeros((n_loc // 8,), dtype=torch.uint32)
    with pytest.raises(ValueError, match="window % \\(32//qbits\\)"):
        qs.sharded_sample_reconstruct(spec, q, 1, 0, 4, qbits=4, qpacked=True)
    with pytest.raises(ValueError, match="whole upload lanes"):
        qs.sharded_sample_pack(spec, torch.zeros(n_loc), 1, 0, 4)
    with pytest.raises(ValueError, match="outside"):
        qs.shard_windows(spec, 4, 4)
