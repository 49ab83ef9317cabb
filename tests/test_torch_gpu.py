"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: without a CUDA device every test skips (decided inside
the fixture).  On the card:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
This is chip_smoke.py's kernel phases at a small size.  The serve
kernel must equal the plain version bitwise (f32, u8 and u16 words, B
in {1, 2, 3, 4, 5, 128}, every group, d in {1, 8, 16}, d_out below bm
and ragged against the tile, rows per window no multiple of bm, groups
starting inside a window), count one launch a call and give each batch
row its B=1 result; Q indices and mask bits must be exact, and the
engine's scheduler lanes must give a single request's tokens.  The
training kernels (sample-reconstruct at K=3 and K=1, the plan backward,
the sample-pack upload, and its one-client launch, which must also
equal the batched kernel's row, at a window of 16 too) must equal
their plain versions bitwise, count one launch each, and the
card-built plan's values must equal the kernels' regenerated Q; a
federated round through them must equal one on the plain path.  The
local-zampling kernels (the reconstruct forward from explicit operands
at K=1 and K=3, the K=1 plan backward) and the sample-reconstruct
forward must equal their plain versions at every d
the paper runs, up to 256; a local training step through the kernels
must equal one on the plain path in sample and continuous mode; the
composed round must equal the fused round.  The scatter transpose
kernels (kernel 4 at K in {4, 10}, kernel 2 at K=1) must equal their
plain versions and the plan kernels on the canonical plan bitwise at d
in {1, 8, 16, 256}, with rows per window that do not divide the rows
and a ragged last window, give the same bits on a second launch, and an
LM round under ``REPRO_BWD_PLAN=scatter`` through them must equal the
plain path's.  The one-client backward kernels (2 and 5) at the leaves
they run at, Fig. 6's at d in {1, 16, 256} and Fig. 4's at d=10, on
cotangents with zero rows, a window of zeros and -0 entries, must equal
their plain versions, the K-client kernels' rows (4 and 6) and each
other on the canonical plan bitwise, kernel 5 the slot plan's plain
version too, and give the same bits on a second launch.  The forward
kernels (8 on f32, u8 and u16 operands, 3, and their K=1 launches 7 and
1) at those specs and at Fig. 4's leaves, K in {1, 3, 10, 33}, must
equal their plain versions by bits (-0 is not +0), with a client at p =
0 over a window and explicit operands holding -0 and negatives; so must
kernels 8 and 7 on packed lanes (b in {2, 3, 4}, a partial last lane,
clients at p = 0 and p = 1 over a window).
"""

import numpy as np
import pytest
import torch

from repro_torch.comm.bitpack import pack_words, packed_word_len
from repro_torch.comm.downlink import get_codec, packed_codec
from repro_torch.configs import get_arch
from repro_torch.configs.mnistfc import MNISTFC
from repro_torch.core.qspec import make_qspec, row_indices
from repro_torch.core.zampling import ZamplingConfig, build_specs, init_state
from repro_torch.core.federated import FederatedConfig, encode_state
from repro_torch.core.federated import federated_round
from repro_torch.core.sampling import as_words, clip_probs, sample_mask_hash
from repro_torch.core.transpose_plan import row_plan
from repro_torch.kernels import ops, qz_decode, qz_reconstruct
from repro_torch.launch import train as lm_train
from repro_torch.models.mlp import SMALL_DIMS, mlp_loss, mlp_template
from repro_torch.models.model import build_model, param_template
from repro_torch.optim import adam
from repro_torch.train import train_step
from repro_torch.serve import (ServeConfig, ServeScheduler,
                               make_serve_state, serve_generate)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qz_decode.build()
    return torch.device("cuda")


def _operand(codec, spec, dev, seed=0):
    s = torch.from_numpy(
        np.random.RandomState(seed).rand(spec.n).astype(np.float32)).to(dev)
    c = get_codec(codec)
    qbits = c.bits if c.quantized else None
    return ops.serve_operand(c.encode(spec, s, 3), qbits), qbits


# (shape, d): every group of each spec at B in SERVE_BATCHES.  Wide: d_out
# >= bm, every row flushes, rows_per_window 4096; d_out 16037 takes
# 64-column tiles over a cluster of 5, each CTA walking 12-13 of a tile's
# columns, the last tile ragged.  Ragged: d_out 1001 is
# no multiple of a tile, rows_per_window 4086 no multiple of bm = 256,
# and groups 1 and 2 start inside a window.  Narrow: d_out 128 < bm (rows
# i and i+1 share a block), and d_out 100, where a block holds 2-3 rows
# of a column and crosses a window edge (rows_per_window 3945), groups
# starting inside a window.  d in {1, 16} take the run-time degree.
SERVE_CASES = [((2, 640, 384), 8), ((3, 200, 1001), 8),
               ((1, 300, 16037), 8), ((2, 96, 128), 8),
               ((5, 71, 100), 8), ((3, 200, 1001), 1), ((3, 200, 1001), 16),
               ((5, 71, 100), 16)]
SERVE_BATCHES = (1, 2, 3, 4, 5, 128)


def _serve_call(spec, p, X, off, d_in, d_out, qbits):
    """The kernel at X's batch (matvec at B=1), checking one launch."""
    name = "qz_sample_matvec" if X.shape[0] == 1 else "qz_sample_matmul"
    before = qz_decode.LAUNCHES[name]
    if X.shape[0] == 1:
        y = qz_decode.qz_sample_matvec(spec, p, 5, X[0], row_offset=off,
                                       d_in=d_in, d_out=d_out,
                                       qbits=qbits)[None]
    else:
        y = qz_decode.qz_sample_matmul(spec, p, 5, X, row_offset=off,
                                       d_in=d_in, d_out=d_out, qbits=qbits)
    assert qz_decode.LAUNCHES[name] == before + 1
    return y


@pytest.mark.parametrize("codec", ["f32", "u8", "u16"])
@pytest.mark.parametrize("shape,d", SERVE_CASES)
def test_kernel_equals_plain(cuda, codec, shape, d):
    spec = make_qspec(7, shape, shape[1], compression=8, d=d)
    groups, d_in, d_out = ops.serve_group_dims(spec)
    p, qbits = _operand(codec, spec, cuda)
    rng = np.random.RandomState(d_out)
    for B in SERVE_BATCHES:
        X = torch.from_numpy(rng.randn(B, d_in).astype(np.float32)).to(cuda)
        for g in range(groups):
            off = g * d_in * d_out
            yk = _serve_call(spec, p, X, off, d_in, d_out, qbits)
            yp = ops.serve_contract_plain(spec, p, 5, X, off, d_in, d_out,
                                          qbits)
            torch.cuda.synchronize()
            assert torch.equal(yk, yp), (B, g, (yk - yp).abs().max().item())
            if B > 1:
                rows = torch.cat([_serve_call(spec, p, X[b:b + 1], off, d_in,
                                              d_out, qbits)
                                  for b in range(B)])
                assert torch.equal(yk, rows), (B, g)


def test_box_muller_equals_library(cuda):
    """logf, sqrtf, cosf and the Box-Muller of the kernels' header equal
    the library's at all 2^24 uniforms a draw can give."""
    assert qz_decode.gauss_check(cuda) == (0, 0, 0, 0)


@pytest.mark.parametrize("codec", ["f32", "u8"])
def test_edges_exact(cuda, codec):
    spec = make_qspec(3, (512, 256), 512, compression=8, d=8)
    p, qbits = _operand(codec, spec, cuda, seed=1)
    rows = torch.arange(spec.m, device=cuda)
    idx, bits, vals, w = qz_decode.qz_edges(spec, p, 9, rows, qbits)
    assert torch.equal(idx.to(torch.int64), row_indices(spec, rows))
    assert torch.equal(bits.to(torch.float32),
                       ops.serve_edge_bits(spec, p, 9, rows, qbits))
    assert bool((w == ops.serve_edge_weights(spec, p, 9, rows, qbits)).all())


def test_scheduler_lane_equals_single_request(cuda):
    cfg = get_arch("qwen2-0.5b").reduced()
    zspecs = build_specs(param_template(cfg),
                         ZamplingConfig(compression=8, d=8, min_size=1024))
    rng = np.random.RandomState(0)
    state = {"scores": {p: rng.rand(s.n).astype(np.float32)
                        for p, s in zspecs.specs.items()},
             "dense": {p: np.ones(zspecs.template[p].shape, np.float32)
                       for p in zspecs.dense_paths}}
    sstate = make_serve_state(zspecs, state, 2, downlink="u8", device=cuda)
    model = build_model(cfg)
    sched = ServeScheduler(model, sstate, ServeConfig(
        lanes=2, seq_len=8, mode="streaming", max_new_tokens=3), device=cuda)
    prompts = [[5, 17], [1, 2, 3]]
    rids = [sched.submit(p) for p in prompts]
    results = sched.run()
    for rid, p in zip(rids, prompts):
        out = serve_generate(model, sstate, torch.tensor([p]), 3, seq_len=8,
                             device=cuda)
        assert out[0, len(p):].tolist() == results[rid].tolist()


# multi-window with a ragged last window; padding rows (m_pad > m)
TRAIN_SPECS = [((96, 80), 96, 128), ((7, 300), 7, 64)]


@pytest.fixture
def cuda_train():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qz_reconstruct.build()
    qz_decode.build()
    return torch.device("cuda")


def _train_spec(i):
    shape, fan_in, window = TRAIN_SPECS[i]
    return make_qspec(5, shape, fan_in, compression=8, d=10, window=window,
                      seed=1)


def _counted(name, fn):
    before = qz_reconstruct.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert qz_reconstruct.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("i", range(len(TRAIN_SPECS)))
def test_training_kernels_equal_plain(cuda_train, i):
    spec = _train_spec(i)
    rng = np.random.RandomState(i)
    P = clip_probs(torch.from_numpy(
        rng.rand(3, spec.n).astype(np.float32) * 1.4 - 0.2).to(cuda_train))
    steps = as_words(rng.randint(0, 2**32, 3, dtype=np.uint64), cuda_train)
    W = _counted("qz_sample_reconstruct_batched_fwd",
                 lambda: qz_reconstruct.qz_sample_reconstruct_batched_fwd(
                     spec, P, steps))
    assert torch.equal(W, ops.sample_reconstruct_plain(spec, P, steps))
    for k in range(3):
        assert torch.equal(_counted(
            "qz_sample_reconstruct_fwd",
            lambda: qz_reconstruct.qz_sample_reconstruct_fwd(
                spec, P[k], steps[k:k + 1])), W[k])
    codec = get_codec("u8")
    q = codec.encode(spec, P[0], 7)
    w8 = qz_reconstruct.qz_sample_reconstruct_fwd(spec, q, steps[:1], 8)
    assert torch.equal(w8, ops.sample_reconstruct_plain(
        spec, q[None], steps[:1], 8)[0])
    assert torch.equal(w8, qz_reconstruct.qz_sample_reconstruct_fwd(
        spec, codec.decode(spec, q), steps[:1]))
    G = torch.from_numpy(rng.randn(3, spec.m).astype(np.float32)).to(
        cuda_train)
    assert torch.equal(_counted(
        "qz_reconstruct_batched_bwd_plan",
        lambda: qz_reconstruct.qz_reconstruct_batched_bwd_plan(spec, G)),
        ops.plan_bwd_plain(spec, G))
    assert torch.equal(_counted(
        "qz_sample_pack_batched_fwd",
        lambda: qz_reconstruct.qz_sample_pack_batched_fwd(spec, P, steps)),
        ops.sample_pack_plain(spec, P, steps))
    # the plan's values (built on the card) are the kernels' Q values
    gidx, vals = row_plan(spec, cuda_train)
    rows = torch.arange(spec.m, device=cuda_train)
    idx, _, kvals, _ = qz_decode.qz_edges(spec, P[0], 0, rows)
    assert torch.equal(vals[:spec.m], kvals)
    assert torch.equal(gidx[:spec.m], (rows // spec.rows_per_window)[:, None]
                       * spec.window + idx.to(torch.int64))


@pytest.mark.parametrize("i", range(len(TRAIN_SPECS)))
def test_one_client_pack_equals_plain_and_the_batched_row(cuda_train, i):
    spec = _train_spec(i)
    rng = np.random.RandomState(40 + i)
    P = clip_probs(torch.from_numpy(
        rng.rand(3, spec.n).astype(np.float32) * 1.4 - 0.2).to(cuda_train))
    words = [int(w) for w in rng.randint(0, 2**32, 3, dtype=np.uint64)]
    rows = qz_reconstruct.qz_sample_pack_batched_fwd(
        spec, P, as_words(words, cuda_train))
    for k in range(3):
        p = P[k].contiguous()
        lanes = _counted("qz_sample_pack_fwd",
                         lambda: qz_reconstruct.qz_sample_pack_fwd(
                             spec, p, words[k]))
        assert torch.equal(lanes, ops.sample_pack_one_plain(spec, p,
                                                            words[k]))
        assert torch.equal(lanes, rows[k])
        assert torch.equal(_counted(
            "qz_sample_pack_fwd",
            lambda: ops.sample_pack(spec, p, words[k])), lanes)


def test_one_client_pack_at_a_window_of_16(cuda_train):
    """The pack kernel draws by coordinate, so a window that is not a
    whole number of lanes packs too: ``ops.sample_pack`` launches kernel
    9 there, equal to the plain version and to kernel 10's row."""
    spec = make_qspec(5, (40, 100), 40, compression=8, d=4, window=16,
                      seed=1)
    assert spec.window % 32
    rng = np.random.RandomState(50)
    P = clip_probs(torch.from_numpy(
        rng.rand(2, spec.n).astype(np.float32) * 1.4 - 0.2).to(cuda_train))
    words = [int(w) for w in rng.randint(0, 2**32, 2, dtype=np.uint64)]
    rows = qz_reconstruct.qz_sample_pack_batched_fwd(
        spec, P, as_words(words, cuda_train))
    for k in range(2):
        p = P[k].contiguous()
        lanes = _counted("qz_sample_pack_fwd",
                         lambda: ops.sample_pack(spec, p, words[k]))
        assert torch.equal(lanes, ops.sample_pack_one_plain(spec, p,
                                                            words[k]))
        assert torch.equal(lanes, rows[k])


def test_round_through_kernels_equals_plain(cuda_train):
    zspecs = build_specs(mlp_template(SMALL_DIMS), ZamplingConfig(
        compression=8, d=10, window=128, min_size=128, seed=1))
    rng = np.random.RandomState(0)
    state = {"scores": {p: rng.rand(s.n).astype(np.float32)
                        for p, s in zspecs.specs.items()},
             "dense": {p: np.zeros(zspecs.template[p].shape, np.float32)
                       for p in zspecs.dense_paths}}
    cfg = FederatedConfig(num_clients=3, local_steps=2, local_lr=0.5,
                          aggregate="psum_u32", downlink="u8")
    st = encode_state(zspecs, cfg, state, device=cuda_train)
    batch = {"x": rng.randn(3, 2, 8, 784).astype(np.float32),
             "y": rng.randint(0, 10, (3, 2, 8)).astype(np.int32)}
    qz_reconstruct.reset_launches()
    a, ma = federated_round(zspecs, st, mlp_loss, batch, 5, cfg,
                            device=cuda_train)
    assert qz_reconstruct.LAUNCHES["qz_sample_reconstruct_batched_fwd"] == 6
    assert qz_reconstruct.LAUNCHES["qz_reconstruct_batched_bwd_plan"] == 6
    assert qz_reconstruct.LAUNCHES["qz_sample_pack_batched_fwd"] == 3
    b, mb = federated_round(zspecs, st, mlp_loss, batch, 5, cfg, impl="ref",
                            device=cuda_train)
    assert torch.equal(ma["loss"], mb["loss"])
    for p in zspecs.specs:
        assert torch.equal(a["scores"][p], b["scores"][p])
    for p in zspecs.dense_paths:
        assert torch.equal(a["dense"][p], b["dense"][p])


@pytest.mark.parametrize("d", [1, 16, 41, 256])
def test_local_kernels_equal_plain_at_every_d(cuda_train, d):
    """Kernels 1, 3 and 5, and 7 and 8 past the 32 edges staged at once,
    against their plain versions."""
    spec = make_qspec(4, (96, 80), 96, compression=1, d=d, window=128,
                      seed=0)
    rng = np.random.RandomState(d)
    P = clip_probs(torch.from_numpy(
        rng.rand(3, spec.n).astype(np.float32) * 1.4 - 0.2).to(cuda_train))
    steps = as_words(rng.randint(0, 2**32, 3, dtype=np.uint64), cuda_train)
    W = _counted("qz_reconstruct_batched_fwd",
                 lambda: qz_reconstruct.qz_reconstruct_batched_fwd(spec, P))
    assert torch.equal(W, ops.reconstruct_plain(spec, P))
    for k in range(3):
        w = _counted("qz_reconstruct_fwd",
                     lambda: qz_reconstruct.qz_reconstruct_fwd(spec, P[k]))
        assert torch.equal(w, W[k])
    g = torch.from_numpy(rng.randn(spec.m).astype(np.float32)).to(cuda_train)
    gz = _counted("qz_reconstruct_bwd_plan",
                  lambda: qz_reconstruct.qz_reconstruct_bwd_plan(spec, g))
    assert torch.equal(gz, ops.plan_bwd_one_plain(spec, g))
    assert torch.equal(gz, qz_reconstruct.qz_reconstruct_batched_bwd_plan(
        spec, g[None])[0])
    W8 = qz_reconstruct.qz_sample_reconstruct_batched_fwd(spec, P, steps)
    assert torch.equal(W8, ops.sample_reconstruct_plain(spec, P, steps))
    assert torch.equal(qz_reconstruct.qz_sample_reconstruct_fwd(
        spec, P[1], steps[1:2]), W8[1])
    Z = sample_mask_hash(P, spec.seed, spec.tensor_id, steps)
    assert torch.equal(qz_reconstruct.qz_reconstruct_batched_fwd(spec, Z),
                       W8)


@pytest.mark.parametrize("mode", ["sample", "continuous"])
def test_local_step_through_kernels_equals_plain(cuda_train, mode):
    zs = build_specs(mlp_template(SMALL_DIMS), ZamplingConfig(
        compression=4, d=5, window=128, min_size=128))
    rng = np.random.RandomState(1)
    st = init_state(zs, {p: rng.rand(s.n).astype(np.float32)
                         for p, s in zs.specs.items()}, device=cuda_train)
    batch = {"x": torch.from_numpy(rng.randn(16, 784).astype(np.float32)
                                   ).to(cuda_train),
             "y": torch.from_numpy(rng.randint(0, 10, 16)).to(cuda_train)}
    opt = adam(1e-2)
    out = []
    for impl in (None, "ref"):
        qz_reconstruct.reset_launches()
        out.append(train_step(zs, st, opt.init({**st["scores"],
                                                **st["dense"]}), batch, 9,
                              mlp_loss, opt, mode=mode, impl=impl))
        torch.cuda.synchronize()
        fwd = ("qz_sample_reconstruct_fwd" if mode == "sample"
               else "qz_reconstruct_fwd")
        want = {fwd: 3, "qz_reconstruct_bwd_plan": 3} if impl is None else {}
        assert {k: v for k, v in qz_reconstruct.LAUNCHES.items() if v} == want
    (a, _, la, ga), (b, _, lb, gb) = out
    assert torch.equal(la, lb)
    for part in ("scores", "dense"):
        for p in a[part]:
            assert torch.equal(a[part][p], b[part][p])
            assert torch.equal(ga[part][p], gb[part][p])


def test_composed_round_equals_fused_round(cuda_train):
    zspecs = build_specs(mlp_template(SMALL_DIMS), ZamplingConfig(
        compression=8, d=10, window=128, min_size=128, seed=1))
    rng = np.random.RandomState(2)
    state = {"scores": {p: rng.rand(s.n).astype(np.float32)
                        for p, s in zspecs.specs.items()},
             "dense": {p: np.zeros(zspecs.template[p].shape, np.float32)
                       for p in zspecs.dense_paths}}
    batch = {"x": rng.randn(3, 2, 8, 784).astype(np.float32),
             "y": rng.randint(0, 10, (3, 2, 8)).astype(np.int32)}
    out = []
    for path in ("fused", "composed"):
        cfg = FederatedConfig(num_clients=3, local_steps=2, local_lr=0.5,
                              aggregate="psum_u32", downlink="u8",
                              mask_path=path)
        st = encode_state(zspecs, cfg, state, device=cuda_train)
        qz_reconstruct.reset_launches()
        out.append(federated_round(zspecs, st, mlp_loss, batch, 5, cfg,
                                   device=cuda_train))
        torch.cuda.synchronize()
        launched = {k: v for k, v in qz_reconstruct.LAUNCHES.items() if v}
        assert launched == ({"qz_sample_reconstruct_batched_fwd": 6,
                             "qz_reconstruct_batched_bwd_plan": 6,
                             "qz_sample_pack_batched_fwd": 3}
                            if path == "fused" else
                            {"qz_reconstruct_batched_fwd": 6,
                             "qz_reconstruct_batched_bwd_plan": 6})
    (a, ma), (b, mb) = out
    assert torch.equal(ma["loss"], mb["loss"])
    for p in zspecs.specs:
        assert torch.equal(a["scores"][p], b["scores"][p])
    for p in zspecs.dense_paths:
        assert torch.equal(a["dense"][p], b["dense"][p])


# (shape, fan_in, compression, d, window): fewer rows per window than
# compression x window (as qwen2-0.5b's bq/ln1/ln2), a ragged last
# window, d=1, d=8 at qwen2-0.5b's window, d=256 at Fig. 6's compression
SCATTER_SPECS = [((6, 112), 6, 8, 8, 16), ((7, 301), 7, 8, 10, 64),
                 ((64, 48), 64, 4, 1, 64), ((48, 700), 48, 8, 8, 512),
                 ((96, 80), 96, 1, 16, 128), ((24, 40), 24, 1, 256, 512)]


@pytest.mark.parametrize("K", [1, 2, 4, 10, 33])
@pytest.mark.parametrize("i", range(len(SCATTER_SPECS)))
def test_scatter_kernels_equal_plain_and_plan(cuda_train, i, K):
    """Kernels 4 and 6 (K=33 crosses the scatter's client groups of 8 and,
    at the wider windows, its sweeps and the plan walk's cotangent
    groups) against their plain versions, each other and a second
    launch; kernels 2 and 5 against their rows."""
    shape, fan_in, c, d, window = SCATTER_SPECS[i]
    spec = make_qspec(6, shape, fan_in, compression=c, d=d, window=window,
                      seed=2)
    rng = np.random.RandomState(10 * i + K)
    G = rng.randn(K, spec.m).astype(np.float32)
    G[:, ::3] = 0.0  # rows whose cotangent is 0 for every client
    G[rng.rand(K, spec.m) < 0.2] = 0.0  # and for some
    G = torch.from_numpy(G).to(cuda_train)
    out = _counted("qz_reconstruct_batched_bwd",
                   lambda: qz_reconstruct.qz_reconstruct_batched_bwd(spec, G))
    assert torch.equal(out, ops.scatter_bwd_plain(spec, G))
    assert torch.equal(out, qz_reconstruct.qz_reconstruct_batched_bwd(
        spec, G))  # a second launch, the same bits
    plan = {}
    for order in ("canonical", "slot"):
        plan[order] = _counted(
            "qz_reconstruct_batched_bwd_plan",
            lambda: qz_reconstruct.qz_reconstruct_batched_bwd_plan(
                spec, G, order))
        assert torch.equal(plan[order], ops.plan_bwd_plain(spec, G, order))
        assert torch.equal(plan[order],
                           qz_reconstruct.qz_reconstruct_batched_bwd_plan(
                               spec, G, order))
    assert torch.equal(out, plan["canonical"])
    for k in sorted({0, K // 2, K - 1}):
        one = _counted("qz_reconstruct_bwd",
                       lambda: qz_reconstruct.qz_reconstruct_bwd(spec, G[k]))
        assert torch.equal(one, out[k])
        for order in ("canonical", "slot"):
            assert torch.equal(qz_reconstruct.qz_reconstruct_bwd_plan(
                spec, G[k], order), plan[order][k])


def _same_bits(a, b):
    """Equal bits: -0 and +0 differ (``torch.equal`` counts them equal)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


# The forward's specs: SCATTER_SPECS (each with fewer windows than the
# card has SMs, so every window is split over CTAs; a ragged last
# window; d in {1, 8, 10, 16, 256}) and Fig. 4's three leaves
FWD_SPECS = [("gpu spec %d" % i, make_qspec(6, shape, fan_in, compression=c,
                                             d=d, window=window, seed=2))
             for i, (shape, fan_in, c, d, window) in enumerate(SCATTER_SPECS)]
FWD_SPECS += [(f"Fig. 4 {p}", s) for p, s in build_specs(
    mlp_template(MNISTFC), ZamplingConfig(
        compression=8, d=10, window=128, min_size=128, seed=1)).specs.items()]


@pytest.mark.parametrize("K", [1, 3, 10, 33])
@pytest.mark.parametrize("i", range(len(FWD_SPECS)))
def test_forward_kernels_equal_plain_by_bits(cuda_train, i, K):
    """Kernels 8 (f32, u8 and u16 operands) and 3 against their plain
    versions by bits, kernels 7 and 1 against their rows, kernel 3 on 8's
    masks against 8, with client 0 at p = 0 over window 0 (every product
    of its rows there is +-0) and explicit operands holding -0 and
    negatives; K=33 takes two client words and two groups."""
    _, spec = FWD_SPECS[i]
    rng = np.random.RandomState(20 * i + K)
    P = np.clip(rng.rand(K, spec.n) * 1.4 - 0.2, 0, 1).astype(np.float32)
    P[0, :spec.window] = 0.0
    P = torch.from_numpy(P).to(cuda_train)
    steps = as_words(rng.randint(0, 2**32, K, dtype=np.uint64), cuda_train)
    W = _counted("qz_sample_reconstruct_batched_fwd",
                 lambda: qz_reconstruct.qz_sample_reconstruct_batched_fwd(
                     spec, P, steps))
    assert _same_bits(W, ops.sample_reconstruct_plain(spec, P, steps))
    for k in sorted({0, K // 2, K - 1}):
        assert _same_bits(_counted(
            "qz_sample_reconstruct_fwd",
            lambda: qz_reconstruct.qz_sample_reconstruct_fwd(
                spec, P[k], steps[k:k + 1])), W[k])
    for qbits, dtype in ((8, np.uint8), (16, np.uint16)):
        q = rng.randint(0, 1 << qbits, (K, spec.n))
        q[0, :spec.window] = 0
        q = torch.from_numpy(q.astype(dtype)).to(cuda_train)
        Wq = qz_reconstruct.qz_sample_reconstruct_batched_fwd(spec, q, steps,
                                                             qbits)
        assert _same_bits(Wq, ops.sample_reconstruct_plain(spec, q, steps,
                                                           qbits))
        assert _same_bits(qz_reconstruct.qz_sample_reconstruct_fwd(
            spec, q[K - 1], steps[K - 1:], qbits), Wq[K - 1])
    Z = sample_mask_hash(P, spec.seed, spec.tensor_id, steps)
    assert _same_bits(_counted(
        "qz_reconstruct_batched_fwd",
        lambda: qz_reconstruct.qz_reconstruct_batched_fwd(spec, Z)), W)
    Zs = torch.from_numpy(rng.randn(K, spec.n).astype(np.float32)).to(
        cuda_train)
    Zs[:, ::3] = 0.0
    Zs[:, 1::5] = -0.0
    Zs[0, :spec.window] = -0.0
    W3 = qz_reconstruct.qz_reconstruct_batched_fwd(spec, Zs)
    assert _same_bits(W3, ops.reconstruct_plain(spec, Zs))
    for k in sorted({0, K - 1}):
        assert _same_bits(_counted(
            "qz_reconstruct_fwd",
            lambda: qz_reconstruct.qz_reconstruct_fwd(spec, Zs[k])), W3[k])
    # a second launch, the same bits
    assert _same_bits(qz_reconstruct.qz_sample_reconstruct_batched_fwd(
        spec, P, steps), W)
    assert _same_bits(qz_reconstruct.qz_reconstruct_batched_fwd(spec, Zs), W3)


def _local_bwd_specs():
    """The leaves kernels 2 and 5 run at: Fig. 6's at d in {1, 16, 256}
    (the spec caps 256 at window/2 = 64) and Fig. 4's at d=10; and two
    with more rows a window than kernel 5 stages cotangents for (16384
    rows) or than uint16 holds (131072 rows: 32-bit plan rows), which
    both kernels take in many passes."""
    out = []
    for d in (1, 16, 256):
        zs = build_specs(mlp_template(MNISTFC), ZamplingConfig(
            compression=1.0, d=d, window=128, min_size=128, seed=0))
        out += [(f"Fig. 6 {p} d={d}", s) for p, s in zs.specs.items()]
    zs = build_specs(mlp_template(MNISTFC), ZamplingConfig(
        compression=8, d=10, window=128, min_size=128, seed=1))
    out += [(f"Fig. 4 {p}", s) for p, s in zs.specs.items()]
    return out + [(f"{shape} at compression {c}", make_qspec(
        8, shape, shape[0], compression=c, d=8, window=512, seed=4))
        for shape, c in (((128, 256), 32), ((256, 512), 256))]


LOCAL_BWD_SPECS = _local_bwd_specs()


@pytest.mark.parametrize("i", range(len(LOCAL_BWD_SPECS)))
def test_one_client_backward_kernels_equal_plain_and_batched(cuda_train, i):
    _, spec = LOCAL_BWD_SPECS[i]
    g = np.random.RandomState(100 + i).randn(spec.m).astype(np.float32)
    g[::3] = 0.0  # rows whose cotangent is 0
    g[1::5] = -0.0
    g[:spec.rows_per_window] = 0.0  # a whole window of zeros
    g = torch.from_numpy(g).to(cuda_train)
    G = g[None].contiguous()
    k2 = _counted("qz_reconstruct_bwd",
                  lambda: qz_reconstruct.qz_reconstruct_bwd(spec, g))
    k5 = _counted("qz_reconstruct_bwd_plan",
                  lambda: qz_reconstruct.qz_reconstruct_bwd_plan(spec, g))
    assert torch.equal(k2, ops.scatter_bwd_one_plain(spec, g))
    assert torch.equal(k5, ops.plan_bwd_one_plain(spec, g))
    assert torch.equal(k2, k5)
    assert torch.equal(k2, qz_reconstruct.qz_reconstruct_batched_bwd(
        spec, G)[0])
    assert torch.equal(k5, qz_reconstruct.qz_reconstruct_batched_bwd_plan(
        spec, G)[0])
    slot = _counted("qz_reconstruct_bwd_plan",
                    lambda: qz_reconstruct.qz_reconstruct_bwd_plan(
                        spec, g, "slot"))
    assert torch.equal(slot, ops.plan_bwd_one_plain(spec, g, "slot"))
    assert torch.equal(slot, qz_reconstruct.qz_reconstruct_batched_bwd_plan(
        spec, G, "slot")[0])
    # a second launch, the same bits
    assert torch.equal(qz_reconstruct.qz_reconstruct_bwd(spec, g), k2)
    assert torch.equal(qz_reconstruct.qz_reconstruct_bwd_plan(spec, g), k5)


def test_lm_round_under_scatter_equals_plain(cuda_train, monkeypatch):
    monkeypatch.setenv("REPRO_BWD_PLAN", "scatter")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    args = lm_train.parser().parse_args(
        ["--scale", "0.01", "--rounds", "1", "--clients", "2",
         "--local-steps", "2", "--batch", "2", "--seq", "16"])
    out = []
    torch.use_deterministic_algorithms(True)
    try:
        for impl in (None, "ref"):
            run = lm_train.build(args)
            qz_reconstruct.reset_launches()
            out.append(federated_round(run.zspecs, run.state, run.loss,
                                       run.batch(), run.words[0], run.fcfg,
                                       impl=impl, device=cuda_train))
            torch.cuda.synchronize()
            n = 2 * len(run.zspecs.specs)
            want = ({"qz_sample_reconstruct_batched_fwd": n,
                     "qz_reconstruct_batched_bwd": n} if impl is None else {})
            assert {k: v for k, v in qz_reconstruct.LAUNCHES.items()
                    if v} == want
    finally:
        torch.use_deterministic_algorithms(False)
    (a, ma), (b, mb) = out
    assert torch.equal(ma["loss"], mb["loss"])
    for part in ("scores", "dense"):
        for p in a[part]:
            assert torch.equal(a[part][p], b[part][p])


# Kernels 7 and 8 on packed lanes: Fig. 4's leaves, and a spec whose
# n = 28 leaves the last lane partial at every width tested
LANE_SPECS = FWD_SPECS[-3:] + [("(7, 11) at window 4, n = 28", make_qspec(
    7, (7, 11), 7, compression=3, d=2, window=4, seed=3))]


@pytest.mark.parametrize("K", [1, 3, 10, 33])
@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("i", range(len(LANE_SPECS)))
def test_forward_kernels_on_packed_lanes_equal_plain_by_bits(cuda_train, i,
                                                             bits, K):
    """Kernel 8 on (K, packed_word_len(n, b)) uint32 lanes against its
    plain version (unpack, then draw) and against the f32 kernel on the
    decoded probabilities, by bits; kernel 7 against its rows; one
    launch each.  Client 0 is at p = 0 over window 0 and client K-1 at
    p = 1 over the last window; b = 3 puts 10 words in a lane, so no
    window of 128 holds whole lanes."""
    _, spec = LANE_SPECS[i]
    rng = np.random.RandomState(7 * i + bits + K)
    q = rng.randint(0, 1 << bits, (K, spec.n))
    q[0, :spec.window] = 0
    q[K - 1, -spec.window:] = (1 << bits) - 1
    lanes = pack_words(torch.from_numpy(q).to(cuda_train), bits)
    assert lanes.dtype == torch.uint32
    assert lanes.shape == (K, packed_word_len(spec.n, bits))
    steps = as_words(rng.randint(0, 2**32, K, dtype=np.uint64), cuda_train)
    W = _counted("qz_sample_reconstruct_batched_fwd",
                 lambda: qz_reconstruct.qz_sample_reconstruct_batched_fwd(
                     spec, lanes, steps, bits, True))
    assert _same_bits(W, ops.sample_reconstruct_plain(spec, lanes, steps,
                                                      bits, qpacked=True))
    dec = packed_codec(bits).decode(spec, lanes)
    assert _same_bits(W, qz_reconstruct.qz_sample_reconstruct_batched_fwd(
        spec, dec, steps))
    for k in sorted({0, K - 1}):
        assert _same_bits(_counted(
            "qz_sample_reconstruct_fwd",
            lambda: qz_reconstruct.qz_sample_reconstruct_fwd(
                spec, lanes[k], steps[k:k + 1], bits, True)), W[k])
    with pytest.raises(ValueError, match="operand must be"):
        qz_reconstruct.qz_sample_reconstruct_batched_fwd(
            spec, lanes[:, :-1].contiguous(), steps, bits, True)
