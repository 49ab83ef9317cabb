"""The training kernels on a model rank's windows, on the card.

Marked ``gpu``: without a CUDA device every test skips (decided inside
the fixture).  On the card:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_model_axis.py
Kernels 1-10 launched on each shard's window range of sharding-major
specs (``shard_count`` in {2, 4, 16}, major axis 0, 1 or 2, blocks with
and without padding rows) must equal, by bits (-0 is not +0), the same
block of their whole-leaf launch and their plain versions over the same
windows, whose concatenation is the plain global op
(``tests/test_torch_qz_sharded.py`` holds that on the CPU): the forward
on f32 probabilities, u8/u16 words and packed lanes (b in {2, 4}) and on
explicit operands, at K in {1, 3, 33}; the plan walk (both orders) and
the scatter at K in {1, 4}; the upload pack at K in {1, 3}.  Each launch
counts once in its wrapper's counter.

The partitioned consumers on the card: the reduced qwen2-0.5b (f32) on a
model group of 2 (whole heads a rank) and of 4 (KV heads split
mid-head), gloo ranks on one card, its loss within ``LOSS_RTOL`` and
every leaf's cotangent block within ``GRAD_RTOL`` of the leaf's largest
unsharded cotangent, as ``tests/test_torch_model_axis.py`` holds them on
the CPU; no matrix leaf gathered whole.
"""

import numpy as np
import pytest
import torch

from repro_torch.comm.downlink import get_codec
from repro_torch.comm.shardmap import run_ranks
from repro_torch.core.qspec import make_qspec
from repro_torch.kernels import ops, qz_reconstruct as qr, qz_sharded as qs
from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import matrix_gathers

import _torch_model_axis_ranks as ranks_mod

pytestmark = pytest.mark.gpu

LOSS_RTOL = 1e-5  # partitioned sums against whole ones, f32
GRAD_RTOL = 1e-5  # of a leaf's largest cotangent

# (shape, major axis, shard count, compression, d, window): blocks with
# padding rows (m_blk < m_pad_loc) and without, every major axis
CASES = [((60, 40), 0, 4, 3.0, 4, 32), ((5, 24, 36), 1, 4, 3.0, 8, 32),
         ((64, 48), 1, 2, 2.0, 4, 32), ((4, 16, 24), 2, 8, 3.0, 4, 32),
         ((3, 32, 40), 1, 16, 3.0, 8, 32), ((96, 160), 1, 4, 8.0, 10, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qr.build()
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _spec(case):
    shape, axis, ms, comp, d, window = case
    spec = make_qspec(5, shape, shape[-2], compression=comp, d=d,
                      window=window, seed=3, major_axis=axis,
                      shard_count=ms, align=ms)
    assert spec.shard_count == ms
    return spec, ms


def _launched(name, fn):
    before = qr.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert qr.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("K", [1, 3, 33])
@pytest.mark.parametrize("codec", ["f32", "u8", "u16", "packed4", "packed2"])
@pytest.mark.parametrize("case", CASES)
def test_sample_forward_on_each_shard(cuda, case, codec, K):
    spec, ms = _spec(case)
    rng = np.random.RandomState(K)
    P = torch.from_numpy(rng.rand(K, spec.n).astype(np.float32)).to(cuda)
    P[0, :spec.window] = 0.0  # a client at p = 0 over a window
    c = get_codec(codec)
    qbits, packed = (c.bits if c.quantized else None), c.packed
    Q = c.encode(spec, P, 9) if c.quantized else P
    steps = torch.arange(11, 11 + K, dtype=torch.int64, device=cuda)
    name = ("qz_sample_reconstruct_fwd" if K == 1
            else "qz_sample_reconstruct_batched_fwd")
    if K == 1:
        whole = qr.qz_sample_reconstruct_fwd(spec, Q[0], steps, qbits,
                                             packed)[None]
    else:
        whole = qr.qz_sample_reconstruct_batched_fwd(spec, Q, steps, qbits,
                                                     packed)
    per = Q.shape[1] * spec.nw_loc // spec.num_windows  # words a shard
    for sid in range(ms):
        win = qs.shard_windows(spec, sid, ms)
        q = Q[:, sid * per:(sid + 1) * per].contiguous()
        if K == 1:
            got = _launched(name, lambda: qr.qz_sample_reconstruct_fwd(
                spec, q[0], steps, qbits, packed, win)[None])
        else:
            got = _launched(name, lambda: qr.qz_sample_reconstruct_batched_fwd(
                spec, q, steps, qbits, packed, win))
        blk = whole[:, sid * spec.m_blk:(sid + 1) * spec.m_blk]
        assert _same(got, blk), sid
        assert _same(got, ops.sample_reconstruct_plain(spec, q, steps, qbits,
                                                       packed, win)), sid


@pytest.mark.parametrize("K", [1, 3, 33])
@pytest.mark.parametrize("case", CASES)
def test_explicit_forward_on_each_shard(cuda, case, K):
    spec, ms = _spec(case)
    rng = np.random.RandomState(K + 7)
    Z = torch.from_numpy(rng.randn(K, spec.n).astype(np.float32)).to(cuda)
    Z[0, 1::5] = -0.0
    whole = qr.qz_reconstruct_batched_fwd(spec, Z)
    n_loc = spec.nw_loc * spec.window
    for sid in range(ms):
        win = qs.shard_windows(spec, sid, ms)
        z = Z[:, sid * n_loc:(sid + 1) * n_loc].contiguous()
        if K == 1:
            got = _launched("qz_reconstruct_fwd", lambda: qr.qz_reconstruct_fwd(
                spec, z[0], win)[None])
        else:
            got = _launched("qz_reconstruct_batched_fwd",
                            lambda: qr.qz_reconstruct_batched_fwd(spec, z, win))
        assert _same(got, whole[:, sid * spec.m_blk:(sid + 1) * spec.m_blk])
        assert _same(got, ops.reconstruct_plain(spec, z, win))


@pytest.mark.parametrize("path", ["plan", "plan:slot", "scatter"])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("case", CASES)
def test_backward_on_each_shard(cuda, case, K, path):
    spec, ms = _spec(case)
    kind, order = ("scatter", None) if path == "scatter" else (
        "plan", path.partition(":")[2] or "canonical")
    rng = np.random.RandomState(K + 11)
    G = torch.from_numpy(rng.randn(K, spec.m).astype(np.float32)).to(cuda)
    G[0, :spec.m_blk // 2] = 0.0  # rows that carry no cotangent
    G[-1, 3::7] = -0.0
    if kind == "plan":
        whole = qr.qz_reconstruct_batched_bwd_plan(spec, G, order)
    else:
        whole = qr.qz_reconstruct_batched_bwd(spec, G)
    n_loc = spec.nw_loc * spec.window
    for sid in range(ms):
        win = qs.shard_windows(spec, sid, ms)
        g = G[:, sid * spec.m_blk:(sid + 1) * spec.m_blk].contiguous()
        if kind == "plan":
            name = ("qz_reconstruct_bwd_plan" if K == 1
                    else "qz_reconstruct_batched_bwd_plan")
            fn = ((lambda: qr.qz_reconstruct_bwd_plan(spec, g[0], order,
                                                      win)[None])
                  if K == 1 else
                  (lambda: qr.qz_reconstruct_batched_bwd_plan(spec, g, order,
                                                              win)))
            plain = ops.plan_bwd_plain(spec, g, order, win)
        else:
            name = ("qz_reconstruct_bwd" if K == 1
                    else "qz_reconstruct_batched_bwd")
            fn = ((lambda: qr.qz_reconstruct_bwd(spec, g[0], win)[None])
                  if K == 1 else
                  (lambda: qr.qz_reconstruct_batched_bwd(spec, g, win)))
            plain = ops.scatter_bwd_plain(spec, g, win)
        got = _launched(name, fn)
        assert _same(got, whole[:, sid * n_loc:(sid + 1) * n_loc]), sid
        assert _same(got, plain), sid


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("case", CASES)
def test_upload_pack_on_each_shard(cuda, case, K):
    spec, ms = _spec(case)
    n_loc = spec.nw_loc * spec.window
    if n_loc % 32:
        pytest.skip("a shard of fewer than whole lanes packs no lanes")
    rng = np.random.RandomState(K + 13)
    P = torch.from_numpy(rng.rand(K, spec.n).astype(np.float32)).to(cuda)
    steps = torch.arange(5, 5 + K, dtype=torch.int64, device=cuda)
    whole = qr.qz_sample_pack_batched_fwd(spec, P, steps)
    for sid in range(ms):
        win = qs.shard_windows(spec, sid, ms)
        p = P[:, sid * n_loc:(sid + 1) * n_loc].contiguous()
        if K == 1:
            got = _launched("qz_sample_pack_fwd", lambda: qr.qz_sample_pack_fwd(
                spec, p[0], 5, win)[None])
        else:
            got = _launched("qz_sample_pack_batched_fwd",
                            lambda: qr.qz_sample_pack_batched_fwd(
                                spec, p, steps, win))
        lanes = n_loc // 32
        assert torch.equal(got, whole[:, sid * lanes:(sid + 1) * lanes])
        assert torch.equal(got, ops.sample_pack_plain(spec, p, steps, win))


@pytest.mark.parametrize("ms", [2, 4])
def test_partitioned_consumers_on_the_card(cuda, tmp_path, ms):
    out = run_ranks(ranks_mod.gpu_lm_blocks, ms, (ms,),
                    mesh=Mesh(("data", "model"), (1, ms)), timeout=300,
                    tmpdir=str(tmp_path))
    for res in out:
        np.testing.assert_allclose(res["loss"][1], res["loss"][0],
                                   rtol=LOSS_RTOL)
        for p, (want, got) in res["grads"].items():
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=GRAD_RTOL * np.abs(want).max())
        assert matrix_gathers(res["counts"][1]) == 0
        assert res["counts"][0]["all_reduce"] == 2 * 4 + 1 + 3 + 1
