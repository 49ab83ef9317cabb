"""Partial participation, streaming and the downlink schedules through
the CUDA kernels, against the plain path on the card.

Marked ``gpu``: without a CUDA device every test skips (decided inside
the fixture).  On the card:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_participation.py
At SMALL_DIMS (784-20-20-10), K=6 clients, E=2 local steps, batch 8,
psum_u32 uplink: a faulted, weighted round through kernels 8, 6 and 10
must equal the plain path's by bits (words, dense leaves, loss,
counters); the round streamed in chunks that divide K and that do not
must give the slab round's words by bits; the scheduled encode on the
card the CPU's words at every width; a frontier round through the
kernels the plain path's, widths included; ``streamed_federated_fit``
must make no synchronising call; and a chunk above the kernels' MAX_K
clients raises.
"""

import warnings

import numpy as np
import pytest
import torch

from repro_torch.comm.downlink import get_codec
from repro_torch.core.federated import (FederatedConfig, encode_state,
                                        federated_round)
from repro_torch.core.qspec import make_qspec
from repro_torch.core.zampling import ZamplingConfig, build_specs
from repro_torch.fault import FaultPlan
from repro_torch.kernels import qz_reconstruct
from repro_torch.models.mlp import SMALL_DIMS, mlp_loss, mlp_template
from repro_torch.train import federated_fit, streamed_federated_fit

pytestmark = pytest.mark.gpu

K, E, B = 6, 2, 8
PLAN = FaultPlan(dropout=0.15, straggler=0.15, corrupt=0.2, duplicate=0.15,
                 seed=26)
IDS = np.asarray([3, 4, 9, 32, 33, 36], np.uint32)  # codes 3, 1, 0, 4, 2, 3
WEIGHTS = np.asarray([4, 5, 2, 5, 3, 14], np.uint32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qz_reconstruct.build()
    return torch.device("cuda")


def _setup(dev, **fc):
    zspecs = build_specs(mlp_template(SMALL_DIMS), ZamplingConfig(
        compression=8, d=10, window=128, min_size=128, seed=1))
    rng = np.random.RandomState(0)
    state = {"scores": {p: rng.rand(s.n).astype(np.float32)
                        for p, s in zspecs.specs.items()},
             "dense": {p: np.zeros(zspecs.template[p].shape, np.float32)
                       for p in zspecs.dense_paths}}
    cfg = FederatedConfig(**{**dict(num_clients=K, local_steps=E,
                                    local_lr=0.5, aggregate="psum_u32",
                                    downlink="u8"), **fc})
    st = encode_state(zspecs, cfg, state, device=dev)
    batch = {"x": rng.randn(K, E, B, 784).astype(np.float32),
             "y": rng.randint(0, 10, (K, E, B)).astype(np.int32)}
    return zspecs, cfg, st, batch


def _same(a, b):
    for part in ("scores", "dense"):
        for p in a[part]:
            x, y = a[part][p], b[part][p]
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y), p
    if "downlink_b" in a:
        assert torch.equal(a["downlink_b"], b["downlink_b"])


def _counters(m):
    return {k: float(v) for k, v in m.items() if k != "loss"}


def test_faulted_round_through_kernels_equals_plain(card):
    zspecs, cfg, st, batch = _setup(card)
    kw = dict(client_ids=IDS, weights=WEIGHTS, faults=PLAN)
    qz_reconstruct.reset_launches()
    a, ma = federated_round(zspecs, st, mlp_loss, batch, 5, cfg,
                            device=card, **kw)
    torch.cuda.synchronize()
    assert qz_reconstruct.LAUNCHES["qz_sample_reconstruct_batched_fwd"] == 6
    assert qz_reconstruct.LAUNCHES["qz_reconstruct_batched_bwd_plan"] == 6
    assert qz_reconstruct.LAUNCHES["qz_sample_pack_batched_fwd"] == 3
    b, mb = federated_round(zspecs, st, mlp_loss, batch, 5, cfg, impl="ref",
                            device=card, **kw)
    _same(a, b)
    assert torch.equal(ma["loss"], mb["loss"])
    assert _counters(ma) == _counters(mb)
    assert float(ma["num_participating"]) == 2
    assert float(ma["num_corrupt"]) == 2


@pytest.mark.parametrize("chunk", [2, 4])
def test_streaming_through_kernels_is_the_slab(card, chunk):
    zspecs, cfg, st, batch = _setup(card)
    kw = dict(client_ids=IDS, weights=WEIGHTS, faults=PLAN)
    slab, sm = federated_round(zspecs, st, mlp_loss, batch, 5, cfg,
                               device=card, **kw)
    scfg = FederatedConfig(**{**cfg.__dict__, "stream_chunk": chunk})
    qz_reconstruct.reset_launches()
    streamed, stm = federated_round(zspecs, st, mlp_loss, batch, 5, scfg,
                                    device=card, **kw)
    torch.cuda.synchronize()
    chunks = -(-K // chunk)
    assert qz_reconstruct.LAUNCHES["qz_sample_pack_batched_fwd"] == 3 * chunks
    _same(streamed, slab)
    assert torch.equal(stm["loss"], sm["loss"])
    assert _counters(stm) == _counters(sm)


@pytest.mark.parametrize("codec", ["u8", "u16", "packed4", "packed2"])
def test_scheduled_encode_on_the_card_is_the_cpus(card, codec):
    spec = make_qspec(3, (96, 80), 96, compression=8, d=10, window=128,
                      seed=1)
    c = get_codec(codec)
    p = np.random.RandomState(1).rand(spec.n).astype(np.float32)
    p[::7], p[1::11] = 0.0, 1.0
    for b in range(1, c.bits + 1):
        got = c.encode_at(spec, torch.from_numpy(p).to(card), 77,
                          torch.tensor(b, device=card))
        want = c.encode_at(spec, torch.from_numpy(p), 77, b)
        assert torch.equal(got.cpu(), want), b


@pytest.mark.parametrize("codec", ["u8", "packed4"])
def test_frontier_round_through_kernels_equals_plain(card, codec):
    zspecs, cfg, st, batch = _setup(card, downlink=codec,
                                    downlink_schedule="frontier",
                                    schedule_b_min=3)
    a, ma = federated_round(zspecs, st, mlp_loss, batch, 5, cfg, device=card)
    b, mb = federated_round(zspecs, st, mlp_loss, batch, 5, cfg, impl="ref",
                            device=card)
    _same(a, b)
    assert a["downlink_b"].is_cuda
    assert float(ma["downlink_bytes_per_client"]) == float(
        mb["downlink_bytes_per_client"])


def test_streamed_fit_makes_no_synchronising_call(card):
    zspecs, cfg, st, batch = _setup(card, stream_chunk=4,
                                    downlink_schedule="frontier")
    items = [(IDS, WEIGHTS, batch["x"], batch["y"])] * 2
    # the kernels' per-shape constants are built (and copied) once, here
    federated_fit(zspecs, st, mlp_loss, {n: np.stack([batch[n]] * 2)
                                         for n in ("x", "y")}, [1, 2], cfg,
                  client_ids=np.stack([IDS] * 2),
                  weights=np.stack([WEIGHTS] * 2), faults=PLAN, device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out, mets = streamed_federated_fit(
                zspecs, st, mlp_loss, iter(items), [1, 2], cfg, faults=PLAN,
                device=card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message)]
    assert not syncs, syncs[:3]
    assert mets["loss"].is_cuda and mets["round_skipped"].is_cuda


def test_a_chunk_above_max_k_raises(card):
    zspecs, cfg, st, _ = _setup(card)
    k = qz_reconstruct.MAX_K + 2
    batch = {"x": torch.zeros(k, 1, 1, 784, device=card),
             "y": torch.zeros(k, 1, 1, dtype=torch.int32, device=card)}
    scfg = FederatedConfig(**{**cfg.__dict__, "local_steps": 1,
                              "stream_chunk": k - 1})
    with pytest.raises(ValueError, match="clients|K <="):
        federated_round(zspecs, st, mlp_loss, batch, 5, scfg, device=card)
