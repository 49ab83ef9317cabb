"""The port's partial participation and streaming round against the JAX
package's, and against the port's own plain and slab rounds.

SMALL_DIMS (784-20-20-10), compression 8, d=10, window 128, E=2 local
steps, batch 8, psum_u32 uplink, u8 downlink; a Dirichlet population of
40 clients (beta 0.5) of the teacher dataset, cohorts of 6 (3 on the
gloo ranks), every fault rate above 0.  Inputs are seeded numpy arrays
and explicit uint32 words; JAX runs under ``jax.jit``.

Exact against JAX: fault thresholds, codes and corrupted lanes, upload
checksums and verdicts, cohorts (ties too), the Dirichlet split and the
cohort stream, every transport's weighted and fold hooks, and a faulted
weighted round's counters, weight sum and realized bytes (its loss
allclose, its words within the flip share of ``test_torch_federated``).
Bitwise inside the port: weight 1 with ``FaultPlan()`` against the plain
round, streaming against the slab at chunks that divide K and that do
not, a skipped round's carry, the streamed fit against the fit, and the
sharded round on 3 gloo ranks against the stacked round (words, widths,
counters; its dense leaves and loss are all-reduced in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import bitpack as jbp, protocol as jprot
from repro.core import federated as jfed
from repro.data import federated_split as jsplit
from repro.fault import plan as jplan, population as jpop
from repro.fault import validate as jval
from repro.models import mlp as jmlp
from repro_torch.comm import bitpack as tbp, protocol as tprot
from repro_torch.comm.shardmap import run_ranks
from repro_torch.core import federated as tfed
from repro_torch.data import federated_split as tsplit, synthetic as tsyn
from repro_torch.fault import plan as tplan, population as tpop
from repro_torch.fault import validate as tval
from repro_torch.models import mlp as tmlp
from repro_torch.train import federated_fit, streamed_federated_fit
from test_torch_federated import (B, DENSE_ATOL, E, FC, LOSS_RTOL,
                                  MAX_FLIP_SHARE, ZC)
from test_torch_wire import _np, wire  # noqa: F401  (a fixture)

import _torch_sharded_ranks as ranks_mod

N, KP = 40, 6  # the population, the cohort
# every rate above 0; seed 26 gives round 0's cohort every fault code
PLAN = dict(dropout=0.15, straggler=0.15, corrupt=0.2, duplicate=0.15,
            seed=26)
RANK_PLAN = {**PLAN, "seed": 7}  # the ranks' 3 clients: corrupt, late, ok
RANK_TIMEOUT = 120.0


def _counters(met):
    return {k: float(met[k]) for k in tfed.PARTICIPATION_METRIC_KEYS
            + tfed.WIRE_METRIC_KEYS}


def _same_state(a, b):
    for part in ("scores", "dense"):
        for p in a[part]:
            x, y = a[part][p], b[part][p]
            assert x.dtype == y.dtype and torch.equal(
                x.view(torch.int32) if x.dtype == torch.float32 else x,
                y.view(torch.int32) if y.dtype == torch.float32 else y), p
    if "downlink_b" in a or "downlink_b" in b:
        assert torch.equal(a["downlink_b"], b["downlink_b"])


@pytest.fixture(scope="module")
def part(wire):
    ds = tsyn.make_teacher_dataset(n_train=240, n_test=60, seed=0)
    clients, hist = tsplit.dirichlet_client_split(ds, N, beta=0.5, seed=0)
    pop = tpop.ClientPopulation(N, sample_counts=tuple(hist.sum(1)), seed=3)
    stream = tsplit.cohort_batch_stream(clients, pop, KP, B, E, seed=0)
    rounds = [next(stream) for _ in range(2)]
    return dict(wire, ds=ds, clients=clients, hist=hist, pop=pop,
                rounds=rounds)


def _round_args(item):
    ids, weights, x, y = item
    return dict(client_ids=ids, weights=weights), {"x": x, "y": y}


# ---------------------------------------------------------------------------
# faults, validation, cohorts, the split
# ---------------------------------------------------------------------------

def test_fault_thresholds_and_draws_exact():
    ids = np.random.RandomState(1).randint(0, 2**32, 300, dtype=np.uint64)
    for rates in ((0.1, 0.2, 0.3, 0.4), (1.0, 0.0, 0.0, 0.0),
                  (0.0, 0.0, 0.0, 1.0), (0.15, 0.15, 0.2, 0.15),
                  (1 / 3, 1 / 7, 0.05, 1e-9)):
        kw = dict(zip(("dropout", "straggler", "corrupt", "duplicate"),
                      rates), seed=5)
        plan, jp = tplan.FaultPlan(**kw), jplan.FaultPlan(**kw)
        assert plan.thresholds() == [int(t) for t in jp.thresholds()]
        for r in (0, 3, 2**32 - 1):
            got = tplan.draw_faults(plan, r, ids.astype(np.int64))
            want = _np(jplan.draw_faults(jp, np.uint32(r),
                                         ids.astype(np.uint32)))
            np.testing.assert_array_equal(got.numpy(), want)
            assert int(tplan.draw_faults(plan, r, [int(ids[0])])[0]) \
                == int(jplan.draw_faults(jp, np.uint32(r), np.uint32(ids[0])))
    with pytest.raises(ValueError):
        tplan.FaultPlan(dropout=0.6, corrupt=0.5)
    with pytest.raises(ValueError):
        tplan.FaultPlan(straggler=-0.1)


@pytest.mark.parametrize("packed", [True, False])
def test_corruption_checksums_and_verdicts_exact(wire, packed):
    zs, jzs = wire["zs"], wire["jzs"]
    rng = np.random.RandomState(2)
    kw = dict(PLAN)
    plan, jp = tplan.FaultPlan(**kw), jplan.FaultPlan(**kw)
    ids = np.asarray([3, 9, 17, 200, 5, 6], np.uint32)
    z = {}
    for p, s in zs.specs.items():
        bits = (rng.rand(KP, s.n) < 0.4).astype(np.float32)
        z[p] = jbp.pack_mask(jnp.asarray(bits)) if packed else bits
    tz = {p: (torch.from_numpy(_np(v).astype(np.int64)) if packed
              else torch.from_numpy(v)) for p, v in z.items()}
    jz_ = {p: jnp.asarray(v) for p, v in z.items()}
    flag = np.asarray([1, 0, 1, 1, 0, 1], bool)
    corrupt = jax.jit(lambda zz, dd, r: jplan.corrupt_uploads(
        jp, zz, dd, jnp.asarray(flag), r, jnp.asarray(ids), jzs, packed))
    for r in (0, 4):
        decl = tval.upload_counts(tz, zs, packed)
        jdecl = jval.upload_counts(jz_, jzs, packed)
        for p in zs.specs:
            np.testing.assert_array_equal(decl[p].numpy(),
                                          _np(jdecl[p]).astype(
                                              decl[p].numpy().dtype))
        got = tplan.corrupt_uploads(plan, tz, decl, torch.from_numpy(flag),
                                    r, torch.from_numpy(ids.astype(np.int64)),
                                    zs, packed)
        want = corrupt(jz_, jdecl, np.uint32(r))
        for p in zs.specs:
            np.testing.assert_array_equal(
                got[p].numpy(), _np(want[p]).astype(got[p].numpy().dtype))
        verdict = tval.validate_uploads(got, decl, zs, packed)
        np.testing.assert_array_equal(
            verdict.numpy(), _np(jval.validate_uploads(want, jdecl, jzs,
                                                       packed)))
        np.testing.assert_array_equal(verdict.numpy(), ~flag)
        # one rank's upload: no client axis
        one = tplan.corrupt_uploads(plan, {p: v[0] for p, v in tz.items()},
                                    {p: v[0] for p, v in decl.items()},
                                    torch.tensor(True), r, int(ids[0]), zs,
                                    packed)
        for p in zs.specs:
            assert torch.equal(one[p], got[p][0])


def test_cohorts_exact_and_ties_by_index(part, monkeypatch):
    pop = part["pop"]
    jp = jpop.ClientPopulation(N, sample_counts=pop.sample_counts, seed=3)
    for r in range(10):
        ids, w = pop.cohort_np(r, KP)
        jids, jw = jp.cohort_np(r, KP)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(w, jw)
        assert ids.dtype == jids.dtype == np.uint32
        tids, tw = pop.sample_cohort(r, KP, device="cpu")
        np.testing.assert_array_equal(tids.numpy(), ids.astype(np.int64))
    np.testing.assert_array_equal(pop.cohort_np(0, N)[0], np.arange(N))
    # tied priorities keep index order, as jnp.argsort's stable sort
    tie = np.asarray([7, 3, 7, 3, 3, 9, 7, 1] * 5, np.int64)
    monkeypatch.setattr(tpop.ClientPopulation, "priorities",
                        lambda self, r, device="cpu": torch.from_numpy(tie))
    monkeypatch.setattr(jpop.ClientPopulation, "priorities",
                        lambda self, r: jnp.asarray(tie.astype(np.uint32)))
    for k in (3, 9, 17):
        np.testing.assert_array_equal(pop.cohort_np(0, k)[0],
                                      jp.cohort_np(0, k)[0])
    with pytest.raises(ValueError):
        pop.cohort_np(0, N + 1)
    with pytest.raises(ValueError):
        tpop.ClientPopulation(3, sample_counts=(1, 0, 2))


def test_dirichlet_split_and_cohort_stream_exact(part):
    ds, pop = part["ds"], part["pop"]
    jds = jsplit.SyntheticClassification(ds.x_train, ds.y_train, ds.x_test,
                                         ds.y_test)
    jclients, jhist = jsplit.dirichlet_client_split(jds, N, beta=0.5,
                                                    seed=0)
    np.testing.assert_array_equal(part["hist"], jhist)
    for a, b in zip(part["clients"], jclients):
        np.testing.assert_array_equal(a.x_train, b.x_train)
        np.testing.assert_array_equal(a.y_train, b.y_train)
    jp = jpop.ClientPopulation(N, sample_counts=pop.sample_counts, seed=3)
    js_ = jsplit.cohort_batch_stream(jclients, jp, KP, B, E, seed=0)
    for got in part["rounds"]:
        for a, b in zip(got, next(js_)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tsplit.dirichlet_client_split(ds, 4, beta=0.0)


# ---------------------------------------------------------------------------
# the weighted and fold hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mean_f32", "psum_u32", "allgather_packed"])
def test_weighted_and_fold_hooks_exact(name):
    t, jt = tprot.get_transport(name), jprot.get_transport(name)
    rng = np.random.RandomState(4)
    n, k = 333, 7
    z = (rng.rand(k, n) < 0.5).astype(np.float32)
    w = np.asarray([3, 0, 1, 14, 2, 1, 7], np.uint32)
    lanes = tbp.pack_mask(torch.from_numpy(z))
    jl = jnp.asarray(lanes.numpy().astype(np.uint32))
    tw = torch.from_numpy(w.astype(np.int64))
    if t.packed_wire:
        got = t.aggregate_stacked_packed_weighted(lanes, n, tw)
        want = _np(jax.jit(lambda l, ww: jt.aggregate_stacked_packed_weighted(
            l, n, ww))(jl, w))
        fold = lambda acc, sl: t.fold_stacked_packed_weighted(  # noqa: E731
            acc, lanes[sl], n, tw[sl])
        assert t.stream_init(n, "cpu").dtype == torch.int64
    else:
        got = t.aggregate_stacked_weighted(torch.from_numpy(z), tw)
        want = _np(jax.jit(jt.aggregate_stacked_weighted)(z, w))
        fold = lambda acc, sl: t.fold_stacked_weighted(  # noqa: E731
            acc, torch.from_numpy(z)[sl], tw[sl])
        assert t.stream_init(n, "cpu").dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(
        got.numpy().dtype))
    # chunk by chunk, any chunking, the one-shot counts
    for cuts in ((0, 7), (0, 2, 4, 6, 7), (0, 3, 7)):
        acc = t.stream_init(n, "cpu")
        for a, b in zip(cuts[:-1], cuts[1:]):
            acc = fold(acc, slice(a, b))
        assert torch.equal(acc, got)
    # at weight 1, the unweighted counts
    ones = torch.ones(k, dtype=torch.int64)
    if t.packed_wire:
        assert torch.equal(t.aggregate_stacked_packed_weighted(lanes, n, ones),
                           tbp.packed_popcount_sum(lanes, n))
    # the bit-level helpers
    np.testing.assert_array_equal(
        tbp.packed_weighted_sum(lanes, n, tw).numpy(),
        _np(jbp.packed_weighted_sum(jl, n, jnp.asarray(w))).astype(np.int64))
    np.testing.assert_array_equal(
        tbp.packed_weighted_fold(got.to(torch.int64), lanes, n, tw).numpy(),
        2 * got.numpy().astype(np.int64))
    np.testing.assert_array_equal(
        tbp.packed_total_popcount(lanes).numpy(),
        _np(jbp.packed_total_popcount(jl)).astype(np.int64))


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------

def _port_state(wire, **fc):
    cfg = tfed.FederatedConfig(**{**FC, "num_clients": KP, **fc})
    st = tfed.encode_state(wire["zs"], cfg, {"scores": wire["scores"],
                                             "dense": wire["dense"]}, 5,
                           device="cpu")
    return cfg, st


def test_faulted_weighted_round_against_jax(part):
    zs, jzs = part["zs"], part["jzs"]
    cfg, st = _port_state(part)
    jcfg = jfed.FederatedConfig(**{**FC, "num_clients": KP})
    jst = jfed.encode_state(jzs, jcfg, {
        "scores": {p: jnp.asarray(v) for p, v in part["scores"].items()},
        "dense": {p: jnp.asarray(v) for p, v in part["dense"].items()}}, 5)
    kw, batch = _round_args(part["rounds"][0])
    plan, jp = tplan.FaultPlan(**PLAN), jplan.FaultPlan(**PLAN)
    codes = tplan.draw_faults(plan, 0, kw["client_ids"].astype(np.int64))
    assert set(codes.tolist()) == {0, 1, 2, 3, 4}  # every fault, and ok
    new, met = tfed.federated_round(zs, st, tmlp.mlp_loss, batch, 7, cfg,
                                    round_index=0, faults=plan, device="cpu",
                                    **kw)
    jnew, jm = jax.jit(lambda s, bb, ids, w: jfed.federated_round(
        jzs, s, jmlp.mlp_loss, bb, np.uint32(7), jcfg, round_index=0,
        client_ids=ids, weights=w, faults=jp))(
        jst, {n: jnp.asarray(v) for n, v in batch.items()},
        jnp.asarray(kw["client_ids"]), jnp.asarray(kw["weights"]))
    got, want = _counters(met), _counters(jm)
    assert got == want
    # codes [corrupt, drop, ok, duplicate, late, corrupt]: the ok and the
    # duplicate client count (once each), at their weights
    assert codes.tolist() == [3, 1, 0, 4, 2, 3]
    assert got["num_participating"] == 2 and got["round_skipped"] == 0
    assert got["num_duplicates"] == 1 and got["num_corrupt"] == 2
    assert got["num_dropped"] == got["num_stragglers"] == 1
    # drops and stragglers spend no uplink; a duplicate spends it twice
    assert got["uplink_bytes_round"] == 5 * got["uplink_bytes_per_client"]
    assert got["weight_sum"] == float(kw["weights"][2] + kw["weights"][3])
    np.testing.assert_allclose(float(met["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    for p in zs.dense_paths:
        np.testing.assert_allclose(new["dense"][p].numpy(),
                                   _np(jnew["dense"][p]), rtol=0,
                                   atol=DENSE_ATOL)
    differ = sum(int((new["scores"][p].numpy() != _np(jnew["scores"][p]))
                     .sum()) for p in zs.specs)
    assert differ <= MAX_FLIP_SHARE * KP * zs.n_total


@pytest.mark.parametrize("agg", ["psum_u32", "mean_f32"])
def test_weight_one_participation_is_the_plain_round(part, agg):
    zs = part["zs"]
    cfg, st = _port_state(part, aggregate=agg)
    _, batch = _round_args(part["rounds"][1])
    plain, pm = tfed.federated_round(zs, st, tmlp.mlp_loss, batch, 9, cfg,
                                     round_index=1, device="cpu")
    for kw in (dict(faults=tplan.FaultPlan()),
               dict(client_ids=np.arange(KP), weights=np.ones(KP, np.int64))):
        new, m = tfed.federated_round(zs, st, tmlp.mlp_loss, batch, 9, cfg,
                                      round_index=1, device="cpu", **kw)
        _same_state(new, plain)
        assert _counters(m) == _counters(pm)
        assert torch.equal(m["loss"].view(torch.int32),
                           pm["loss"].view(torch.int32))


@pytest.mark.parametrize("chunk", [2, 4])
@pytest.mark.parametrize("faulted", [False, True])
def test_streaming_is_the_slab_round(part, chunk, faulted):
    """Chunks of 2 (dividing K=6) and 4 (a last chunk of 2): the scores,
    and here the dense leaves and loss too (their ascending sums run on
    across chunks), bit for bit; the same counters."""
    zs = part["zs"]
    kw, batch = _round_args(part["rounds"][0])
    if faulted:
        kw["faults"] = tplan.FaultPlan(**PLAN)
    else:
        kw = {}
    cfg, st = _port_state(part)
    slab, sm = tfed.federated_round(zs, st, tmlp.mlp_loss, batch, 7, cfg,
                                    round_index=0, device="cpu", **kw)
    scfg = tfed.FederatedConfig(**{**FC, "num_clients": KP,
                                   "stream_chunk": chunk})
    streamed, stm = tfed.federated_round(zs, st, tmlp.mlp_loss, batch, 7,
                                         scfg, round_index=0, device="cpu",
                                         **kw)
    _same_state(streamed, slab)
    assert _counters(stm) == _counters(sm)
    assert torch.equal(stm["loss"], sm["loss"])


def test_skipped_round_carries_the_state(part):
    zs = part["zs"]
    kw, batch = _round_args(part["rounds"][0])
    cfg, st = _port_state(part, downlink_schedule="frontier",
                          min_clients=3)
    st = {**st, "downlink_b": torch.tensor([3, 5, 8])}
    new, m = tfed.federated_round(zs, st, tmlp.mlp_loss, batch, 7, cfg,
                                  round_index=0, faults=tplan.FaultPlan(
                                      **PLAN), device="cpu", **kw)
    assert float(m["num_participating"]) == 2 and float(
        m["round_skipped"]) == 1
    _same_state(new, st)
    # streamed, and with every client dropped
    scfg = tfed.FederatedConfig(**{**FC, "stream_chunk": 4})
    _, st2 = _port_state(part)
    new, m = tfed.federated_round(zs, st2, tmlp.mlp_loss, batch, 7, scfg,
                                  faults=tplan.FaultPlan(dropout=1.0),
                                  device="cpu")
    _same_state(new, st2)
    assert float(m["weight_sum"]) == 0 and float(m["round_skipped"]) == 1
    assert float(m["uplink_bytes_round"]) == 0


def test_streamed_fit_is_the_fit_on_the_same_stream(part):
    zs = part["zs"]
    cfg, st = _port_state(part, stream_chunk=4,
                          downlink_schedule="frontier")
    plan = tplan.FaultPlan(**PLAN)
    words = [31, 32]
    rounds = part["rounds"]
    fit, fm = federated_fit(
        zs, st, tmlp.mlp_loss, {n: np.stack([r[2 + i] for r in rounds])
                                for i, n in enumerate(("x", "y"))}, words,
        cfg, client_ids=np.stack([r[0] for r in rounds]),
        weights=np.stack([r[1] for r in rounds]), faults=plan, device="cpu")
    streamed, sm = streamed_federated_fit(zs, st, tmlp.mlp_loss, iter(rounds),
                                          words, cfg, faults=plan,
                                          device="cpu")
    _same_state(streamed, fit)
    for key, v in fm.items():
        np.testing.assert_array_equal(np.asarray(sm[key]), np.asarray(v))
    assert sm["loss"].shape == (2,)


# ---------------------------------------------------------------------------
# the sharded round's participation, 3 gloo ranks
# ---------------------------------------------------------------------------

def test_sharded_participation_is_the_stacked_round(part, tmp_path):
    """A faulted, weighted, frontier ``sharded_client_fit`` of 2 rounds,
    a client a rank: its collectives, round 0 and fit against the
    stacked round's on the same inputs.  JAX's sharded tests fail on its
    mesh API, so JAX's side is its vmap round (test above), which JAX's
    own tests tie to its sharded round."""
    zs = part["zs"]
    pop = part["pop"]
    stream = tsplit.cohort_batch_stream(part["clients"], pop, 3, B, E,
                                        seed=1)
    rounds = [next(stream) for _ in range(2)]
    cfg, st = _port_state(part, downlink_schedule="frontier",
                          schedule_b_min=3)
    args = {"zc": ZC, "plan": RANK_PLAN, "words": [41, 42],
            "fc": {**FC, "num_clients": 3, "downlink_schedule": "frontier",
                   "schedule_b_min": 3},
            "ids": [r[0] for r in rounds], "weights": [r[1] for r in rounds],
            "batches": [{"x": r[2], "y": r[3]} for r in rounds],
            "state": {**{part_: {p: v.numpy() for p, v in st[part_].items()}
                         for part_ in ("scores", "dense")},
                      "downlink_b": st["downlink_b"].numpy()}}
    res = run_ranks(ranks_mod.rank_participation, 3, (args,),
                    timeout=RANK_TIMEOUT, tmpdir=str(tmp_path))
    r0 = res[0]
    # the precondition of the bitwise comparison: bmm equals mm here
    assert r0["bmm_equals_mm"] == [True] * (len(tmlp.SMALL_DIMS) - 1)
    codes = tplan.draw_faults(tplan.FaultPlan(**RANK_PLAN), 0,
                              rounds[0][0].astype(np.int64)).tolist()
    assert codes == [3, 2, 0]  # corrupt, late, ok
    # every transport's weighted collective: the stacked weighted sum
    w = torch.from_numpy(rounds[0][1].astype(np.int64))
    for p, s in zs.specs.items():
        lanes = torch.from_numpy(np.stack([r["upload"][p] for r in res]))
        want = tbp.packed_weighted_sum(lanes, s.n, w)
        for r in res:
            for t in ("psum_u32", "allgather_packed"):
                np.testing.assert_array_equal(r["collective"][p][t],
                                              want.numpy())
            np.testing.assert_array_equal(r["collective"][p]["mean"],
                                          want.numpy().astype(np.float32))
    for r in res:
        for key in ("round0", "fit"):
            for part_ in ("scores", "dense"):
                for p, v in r0[key][0][part_].items():
                    np.testing.assert_array_equal(r[key][0][part_][p], v)
    for i, key in ((0, "round0"), (1, "fit")):
        state, widths, met = r0[key]
        s_state, s_widths, s_met = r0["stacked"][i]
        for p in zs.specs:
            np.testing.assert_array_equal(state["scores"][p],
                                          s_state["scores"][p])
        np.testing.assert_array_equal(widths, s_widths)
        for p in zs.dense_paths:
            np.testing.assert_allclose(state["dense"][p],
                                       s_state["dense"][p], rtol=1e-6,
                                       atol=1e-7)
        ms = {k: np.asarray(v).reshape(-1)[-1] for k, v in met.items()}
        for name in tfed.PARTICIPATION_METRIC_KEYS + tfed.WIRE_METRIC_KEYS:
            assert float(ms[name]) == float(s_met[name]), name
        np.testing.assert_allclose(float(ms["loss"]), float(s_met["loss"]),
                                   rtol=1e-6)
    assert float(r0["stacked"][0][2]["num_participating"]) == 1
    assert float(r0["stacked"][0][2]["num_corrupt"]) == 1
