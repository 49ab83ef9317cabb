"""The CUDA serve kernel against its plain torch version, on the card.

Marked ``gpu``: without a CUDA device every test skips (decided inside
the fixture).  On the card:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
This is chip_smoke.py's kernel phase at a small size: the kernel must
equal the plain version bitwise (f32, u8 and u16 words, B in {1, 4}, two
groups), with Q indices and mask bits exact, and the engine's scheduler
lanes must give a single request's tokens.
"""

import numpy as np
import pytest
import torch

from repro_torch.comm.downlink import get_codec
from repro_torch.configs import get_arch
from repro_torch.core.qspec import make_qspec, row_indices
from repro_torch.core.zampling import ZamplingConfig, build_specs
from repro_torch.kernels import ops, qz_decode
from repro_torch.models.model import build_model, param_template
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


@pytest.mark.parametrize("codec", ["f32", "u8", "u16"])
@pytest.mark.parametrize("B", [1, 4])
def test_kernel_equals_plain(cuda, codec, B):
    spec = make_qspec(7, (2, 640, 384), 640, compression=8, d=8)
    p, qbits = _operand(codec, spec, cuda)
    X = torch.from_numpy(np.random.RandomState(B).randn(B, 640)
                         .astype(np.float32)).to(cuda)
    for g in (0, 1):
        off = g * 640 * 384
        before = dict(qz_decode.LAUNCHES)
        if B == 1:
            yk = qz_decode.qz_sample_matvec(spec, p, 5, X[0], row_offset=off,
                                            d_in=640, d_out=384,
                                            qbits=qbits)[None]
            name = "qz_sample_matvec"
        else:
            yk = qz_decode.qz_sample_matmul(spec, p, 5, X, row_offset=off,
                                            d_in=640, d_out=384, qbits=qbits)
            name = "qz_sample_matmul"
        assert qz_decode.LAUNCHES[name] == before[name] + 1
        yp = ops.serve_contract_plain(spec, p, 5, X, off, 640, 384, qbits)
        torch.cuda.synchronize()
        assert bool((yk == yp).all()), (yk - yp).abs().max().item()


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
