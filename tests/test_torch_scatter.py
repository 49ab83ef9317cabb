"""The scatter transpose and the slot-order plan against the JAX package.

The port's plain scatter (``core.reconstruct.scatter_apply_batched``,
kernels 2 and 4's plain versions) regenerates a chunk of windows' rows
at a time and holds no plan; it sums each coordinate's incoming edges
from +0 in the canonical (row, k) order, so inside the port it equals
the canonical plan's transpose bit for bit.  Against JAX
(``grad_z_scatter_ref``/``_batched_ref``, an XLA scatter-add, and the
Pallas scatter kernels in interpret mode) it is allclose at the JAX
test's ``rtol=1e-4, atol=1e-5`` (``tests/test_transpose_plan.py``):
Box-Muller's log/cos round differently in XLA and torch, and XLA sums
in its own order.  The slot-order plan's rows, counts and degree equal
JAX's exactly; its values are allclose for the same Box-Muller reason.
The gate's spellings and error messages are JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qspec as jq, reconstruct as jrec
from repro.core import transpose_plan as jtp
from repro.kernels import qz_reconstruct as jpk
from repro_torch.core import qspec as tq, reconstruct as trec
from repro_torch.core import transpose_plan as ttp
from repro_torch.core.zampling import ZamplingConfig, build_specs, init_state
from repro_torch.kernels import ops as tops, qz_reconstruct as tqr
from repro_torch.models.mlp import SMALL_DIMS, mlp_loss, mlp_template
from repro_torch.optim import adam
from repro_torch.train import train_step

BOX_MULLER_ATOL = 4.5e-5  # on unit normals, XLA vs torch log/cos
RTOL, ATOL = 1e-4, 1e-5  # the JAX package's scatter-vs-plan tolerance

# (shape, fan_in, compression, d, window): many windows; fewer rows per
# window than compression x window (qwen2-0.5b's bq/ln1/ln2 leaves have
# 3584 of 4096: 21504 rows over 6 windows of 512; scaled down, 112 of
# 128); a ragged last window (padding rows, m_pad > m); d=1; d=256
SPECS = [((96, 80), 96, 8, 10, 128), ((6, 112), 6, 8, 8, 16),
         ((7, 301), 7, 8, 10, 64), ((64, 48), 64, 4, 1, 64),
         ((24, 40), 24, 1, 256, 512)]


def _specs(i, tid=4):
    shape, fan_in, c, d, window = SPECS[i]
    kw = dict(compression=c, d=d, window=window, seed=1)
    t = tq.make_qspec(tid, shape, fan_in, **kw)
    j = jq.make_qspec(tid, shape, fan_in, **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    return t, j


def _cot(k, spec, seed, zero_rows=True):
    g = np.random.RandomState(seed).randn(k, *spec.shape).astype(np.float32)
    if zero_rows:  # rows whose cotangent is 0 for every client
        g.reshape(k, -1)[:, ::3] = 0.0
    return g


def test_spec_set_covers_uneven_windows():
    t, _ = _specs(1)
    assert (t.num_windows, t.rows_per_window) == (6, 112)
    t, _ = _specs(2)
    assert t.m_pad > t.m and t.m % t.rows_per_window


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_plain_scatter_against_jax_and_the_canonical_plan(i):
    t, j = _specs(i)
    G = _cot(3, t, i)
    ts_ = trec.grad_z_scatter_batched_ref(t, torch.from_numpy(G))
    js_ = np.asarray(jrec.grad_z_scatter_batched_ref(j, jnp.asarray(G)))
    np.testing.assert_allclose(ts_.numpy(), js_, rtol=RTOL, atol=ATOL)
    one = trec.grad_z_scatter_ref(t, torch.from_numpy(G[1]))
    np.testing.assert_allclose(
        one.numpy(), np.asarray(jrec.grad_z_scatter_ref(j, jnp.asarray(G[1]))),
        rtol=RTOL, atol=ATOL)
    assert torch.equal(one, ts_[1])
    # bitwise the canonical plan's transpose, signed zeros included
    plan = trec.grad_z_plan_batched_ref(t, torch.from_numpy(G))
    assert torch.equal(ts_, plan)
    assert torch.equal(torch.signbit(ts_), torch.signbit(plan))


@pytest.mark.parametrize("i", [0, 1, 2])
def test_scatter_kernels_plain_versions_against_the_pallas_kernels(i):
    """The wrappers of kernels 2 and 4 take CPU tensors to their plain
    versions; JAX's scatter kernels run in interpret mode."""
    t, j = _specs(i)
    G = _cot(2, t, 10 + i).reshape(2, -1)
    got = tqr.qz_reconstruct_batched_bwd(t, torch.from_numpy(G))
    assert torch.equal(got, tops.scatter_bwd_plain(t, torch.from_numpy(G)))
    want = np.asarray(jpk.qz_reconstruct_batched_bwd(j, jnp.asarray(G)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    one = tqr.qz_reconstruct_bwd(t, torch.from_numpy(G[0]))
    assert torch.equal(one, got[0])
    np.testing.assert_allclose(
        one.numpy(), np.asarray(jpk.qz_reconstruct_bwd(j, jnp.asarray(G[0]))),
        rtol=RTOL, atol=ATOL)
    assert not any(tqr.LAUNCHES.values())


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_slot_plan_against_jax(i):
    t, j = _specs(i)
    jp = jtp.build_transpose_plan(j, "slot")
    tp = ttp.build_transpose_plan(t, "cpu", "slot")
    assert tp.order == "slot" and tp.deg == jp.deg
    np.testing.assert_array_equal(tp.rows.numpy(), jp.rows)
    np.testing.assert_array_equal(tp.counts.numpy(), jp.counts)
    np.testing.assert_allclose(tp.vals.numpy(), jp.vals, rtol=0,
                               atol=BOX_MULLER_ATOL * t.sigma)
    G = _cot(2, t, 20 + i, zero_rows=False)
    got = trec.grad_z_plan_batched_ref(t, torch.from_numpy(G), "slot")
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jrec.grad_z_plan_batched_ref(j, jnp.asarray(G), "slot")),
        rtol=RTOL, atol=ATOL)
    # kernels 5 and 6 read whatever plan they are given: on CPU tensors
    # their wrappers run plan_apply_batched over the slot plan
    Gm = torch.from_numpy(G.reshape(2, -1))
    assert torch.equal(tqr.qz_reconstruct_batched_bwd_plan(t, Gm, "slot"),
                       got)
    assert torch.equal(tqr.qz_reconstruct_bwd_plan(t, Gm[1], "slot"), got[1])
    canon = trec.grad_z_plan_batched_ref(t, torch.from_numpy(G))
    np.testing.assert_allclose(got.numpy(), canon.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_gate_spellings_and_errors(monkeypatch):
    monkeypatch.delenv("REPRO_BWD_PLAN", raising=False)
    for path in ("plan", "plan:canonical", "plan:slot", "scatter"):
        assert ttp.resolve_bwd_path(path) == jtp.resolve_bwd_path(path)
    assert ttp.default_bwd_path() == jtp.default_bwd_path() == "plan"
    for mod in (ttp, jtp):
        with pytest.raises(ValueError) as err:
            mod.resolve_bwd_path("gather")
        assert str(err.value) == ("unknown bwd path 'gather'; valid paths: "
                                  "plan, plan:canonical, plan:slot, scatter")
        with pytest.raises(ValueError, match="unknown bwd path 'x'"):
            mod.set_default_bwd_path("x")
    try:
        ttp.set_default_bwd_path("scatter")
        assert ttp.resolve_bwd_path() == ("scatter", None)
        monkeypatch.setenv("REPRO_BWD_PLAN", "plan:slot")
        assert ttp.resolve_bwd_path() == ("plan", "slot")  # env overrides
    finally:
        ttp.set_default_bwd_path("plan")
    monkeypatch.setenv("REPRO_BWD_PLAN", "bogus")
    msgs = []
    for mod in (ttp, jtp):
        with pytest.raises(ValueError) as err:
            mod.resolve_bwd_path()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == (
        "REPRO_BWD_PLAN='bogus' is not a valid bwd path; valid: "
        "plan, plan:canonical, plan:slot, scatter")
    with pytest.raises(ValueError, match="unknown plan order"):
        ttp.build_transpose_plan(_specs(0)[0], "cpu", "row")


@pytest.mark.parametrize("path", ["scatter", "plan:slot"])
def test_dispatching_refs_follow_the_gate(monkeypatch, path):
    t, j = _specs(0)
    G = _cot(2, t, 5)
    monkeypatch.setenv("REPRO_BWD_PLAN", path)
    got = trec.grad_z_batched_ref(t, torch.from_numpy(G))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jrec.grad_z_batched_ref(j, jnp.asarray(G))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        trec.grad_z_ref(t, torch.from_numpy(G[0])).numpy(),
        np.asarray(jrec.grad_z_ref(j, jnp.asarray(G[0]))), rtol=RTOL,
        atol=ATOL)
    kind, order = ttp.resolve_bwd_path()
    want = (trec.grad_z_scatter_batched_ref(t, torch.from_numpy(G))
            if kind == "scatter" else
            trec.grad_z_plan_batched_ref(t, torch.from_numpy(G), order))
    assert torch.equal(got, want)


def test_single_client_op_runs_the_gated_transpose(monkeypatch):
    t, _ = _specs(2)
    p = torch.from_numpy(np.random.RandomState(3).rand(t.n).astype(
        np.float32))
    grads = {}
    for path in ("plan", "scatter"):
        monkeypatch.setenv("REPRO_BWD_PLAN", path)
        x = p.clone().requires_grad_(True)
        w = tops.sample_reconstruct(t, x, 17)
        (w * torch.arange(w.numel()).reshape(w.shape).sin()).sum().backward()
        grads[path] = x.grad
    assert torch.equal(grads["plan"], grads["scatter"])


def test_local_step_under_scatter_equals_the_plan(monkeypatch):
    """A local Adam step (sample mode, K=1 ops) takes the scatter's
    backward under ``REPRO_BWD_PLAN=scatter``: the same loss, gradients
    and updated state, bit for bit."""
    zs = build_specs(mlp_template(SMALL_DIMS), ZamplingConfig(
        compression=4, d=5, window=128, min_size=128))
    rng = np.random.RandomState(1)
    st = init_state(zs, {p: rng.rand(s.n).astype(np.float32)
                         for p, s in zs.specs.items()}, device="cpu")
    batch = {"x": torch.from_numpy(rng.randn(16, 784).astype(np.float32)),
             "y": torch.from_numpy(rng.randint(0, 10, 16))}
    opt = adam(1e-2)
    out = []
    for path in ("plan", "scatter"):
        monkeypatch.setenv("REPRO_BWD_PLAN", path)
        out.append(train_step(zs, st, opt.init({**st["scores"],
                                                **st["dense"]}), batch, 9,
                              mlp_loss, opt))
    (a, oa, la, ga), (b, ob, lb, gb) = out
    assert torch.equal(la, lb)
    for part in ("scores", "dense"):
        for p in a[part]:
            assert torch.equal(a[part][p], b[part][p])
            assert torch.equal(ga[part][p], gb[part][p])
    for p in oa.mu:
        assert torch.equal(oa.mu[p], ob.mu[p])
        assert torch.equal(oa.nu[p], ob.nu[p])


def test_scatter_chunks_do_not_change_the_bits(monkeypatch):
    """The plain scatter walks the windows a chunk at a time; any chunk
    size gives the same sums."""
    t, _ = _specs(0)
    G = torch.from_numpy(_cot(2, t, 7))
    full = trec.grad_z_scatter_batched_ref(t, G)
    monkeypatch.setattr(trec, "_SCATTER_CHUNK_EDGES", 1)
    assert torch.equal(trec.grad_z_scatter_batched_ref(t, G), full)
