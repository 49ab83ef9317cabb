"""The port's sharded client round against its stacked round and JAX's.

One client per rank of a ``torch.distributed`` gloo group on CPU
processes, at the ``test_torch_federated.py`` setup: SMALL_DIMS
(784-20-20-10), K=3 ranks, E=2 local steps, batch 8, compression 8, d=10,
window 128, psum_u32 uplink, u8 downlink.  The ranks start once for the
module (``_torch_sharded_ranks.rank_checks`` runs every rank-side check)
and the tests assert on what they return; the single-process checks run
here and spawn nothing.

Bitwise: each rank's draw word against the stacked round's and JAX's;
kernel 9's plain version against JAX's kernel and ``sample_pack``; the
collective means and their u8 words against the stacked aggregate of
the same uploads; the replicated state of every rank; a fit against
sequential rounds; and, because at these shapes ``bmm`` equals the
per-client ``mm`` (checked first), round 0's lanes and u8 words
against the port's stacked round.  Allclose there: the loss and dense
leaves (the all-reduce sums in another order than ``mean0``).  Against
JAX's ``vmap`` round: the tolerances of ``test_torch_federated.py``.
"""

import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import federated as jfed, qspec as jq, sampling as js
from repro.kernels import ops as jops, qz_reconstruct as jqr
from repro.models import mlp as jmlp
from repro_torch import convert
from repro_torch.comm import bitpack as tbp, protocol as tprot
from repro_torch.comm.shardmap import axis_index, axis_size, run_ranks
from repro_torch.core import federated as tfed, qspec as tq, sampling as ts
from repro_torch.kernels import ops as tops, qz_reconstruct as tqr
from repro_torch.models import mlp as tmlp
from test_torch_federated import (DENSE_ATOL, E, FC, K, LOSS_RTOL,
                                  MAX_FLIP_SHARE, ZC)
from test_torch_federated import setup  # noqa: F401  (a fixture)

import _torch_sharded_ranks as ranks_mod

KEY, ROUND = 7, 2
FIT_WORDS = [11, 12]
RANK_TIMEOUT = 120.0  # seconds; the ranks take a few on a CPU


def _np(x):
    return np.asarray(x)


def _eq_state(a, b):
    for part in ("scores", "dense"):
        assert a[part].keys() == b[part].keys()
        for p in a[part]:
            np.testing.assert_array_equal(a[part][p], b[part][p])


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """The ranks' results, rank 0 first, from a round whose input state
    is the JAX package's encoded state carried across by ``convert``."""
    _, st = convert.federated_state_from_jax(setup["jzs"], setup["jst"],
                                             device="cpu")
    # num_clients is not the group's size: the round must not read it
    args = {"zc": ZC, "fc": {**FC, "num_clients": 10}, "key": KEY,
            "round": ROUND,
            "fit_words": FIT_WORDS,
            "state": {part: {p: v.numpy() for p, v in st[part].items()}
                      for part in ("scores", "dense")},
            "batches": setup["batches"]}
    return run_ranks(ranks_mod.rank_checks, K, (args,), timeout=RANK_TIMEOUT,
                     tmpdir=str(tmp_path_factory.mktemp("store")))


# -- single-process checks ---------------------------------------------------

@pytest.mark.parametrize("shape,fan_in,window", [((96, 80), 96, 128),
                                                 ((7, 300), 7, 64)])
def test_kernel9_plain_version_is_the_jax_kernel(shape, fan_in, window):
    """Kernel 9's plain version and the port's ``sample_pack`` against
    the Pallas ``qz_sample_pack_fwd`` (interpret) and JAX's ref path."""
    kw = dict(compression=8, d=10, window=window, seed=1)
    spec = tq.make_qspec(3, shape, fan_in, **kw)
    jspec = jq.make_qspec(3, shape, fan_in, **kw)
    rng = np.random.RandomState(window)
    # a share of exact 0s and 1s, as decoded broadcasts carry
    p = np.clip(rng.rand(spec.n) * 1.4 - 0.2, 0, 1).astype(np.float32)
    for word in (5, 2**32 - 1):
        want = _np(jops.sample_pack(jspec, jnp.asarray(p), np.uint32(word),
                                    impl="ref"))
        if word == 5:  # the Pallas kernel in interpret mode, once
            np.testing.assert_array_equal(want, _np(jqr.qz_sample_pack_fwd(
                jspec, jnp.asarray(p), np.asarray([word], np.uint32))))
        pt = torch.from_numpy(p)
        for got in (tops.sample_pack_one_plain(spec, pt, word),
                    tops.sample_pack(spec, pt, word),
                    tops.sample_pack(spec, pt, word, impl="ref"),
                    tqr.qz_sample_pack_fwd(spec, pt, word)):
            np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        np.testing.assert_array_equal(
            tops.sample_pack_batched(spec, pt[None], [word])[0].numpy(),
            want.astype(np.int64))


def test_sample_pack_of_one_client_dispatches_to_kernel9(monkeypatch):
    """Asked for the kernels, one client's upload goes to kernel 9's
    wrapper (not kernel 10's at K=1), at a window of 16 too: the CUDA
    kernel packs by coordinate, so it needs no whole lanes per window."""
    calls = []

    def spy(name):
        real = getattr(tqr, name)

        def f(*a, **k):
            calls.append(name)
            return real(*a, **k)
        return f

    for name in ("qz_sample_pack_fwd", "qz_sample_pack_batched_fwd"):
        monkeypatch.setattr(tqr, name, spy(name))
    monkeypatch.setattr(tops, "resolve_impl", lambda impl, x: "cuda")
    spec = tq.make_qspec(2, (40, 64), 40, compression=8, d=4, window=128)
    p = torch.from_numpy(np.random.RandomState(0).rand(spec.n)
                         .astype(np.float32))
    lanes = tops.sample_pack(spec, p, 77)
    assert calls == ["qz_sample_pack_fwd"]
    assert torch.equal(lanes, tops.sample_pack_one_plain(spec, p, 77))
    small = tq.make_qspec(2, (6, 10), 6, compression=8, d=4, window=16)
    q = torch.from_numpy(np.random.RandomState(1).rand(small.n)
                         .astype(np.float32))
    assert torch.equal(tops.sample_pack(small, q, 3),
                       tops.sample_pack_one_plain(small, q, 3))
    assert calls == ["qz_sample_pack_fwd", "qz_sample_pack_fwd"]


def test_local_update_on_one_client_is_the_stacked_row(setup):
    """``local_update`` on one word and (E, B, ...) batches: the stacked
    update's row k (lanes bitwise; at these shapes bmm equals mm, so
    the dense leaves and loss are too)."""
    zs, cfg, st = setup["zs"], setup["cfg"], setup["st"]
    b = {n: torch.from_numpy(v) for n, v in setup["batches"][0].items()}
    words = [ts.fold_word(1234, 6, i) for i in range(K)]
    up, dense, loss = tfed.local_update(zs, st, tmlp.mlp_loss, b, words, cfg)
    for k in range(K):
        u1, d1, l1 = tfed.local_update(zs, st, tmlp.mlp_loss,
                                       {n: v[k] for n, v in b.items()},
                                       words[k], cfg)
        assert l1.shape == () and torch.equal(l1, loss[k])
        for p in zs.specs:
            assert torch.equal(u1[p], up[p][k])
        for p in zs.dense_paths:
            assert torch.equal(d1[p], dense[p][k])
    with pytest.raises(ValueError, match="leading shape"):
        tfed.local_update(zs, st, tmlp.mlp_loss, b, words[0], cfg)


def test_collectives_and_round_at_a_world_of_one(setup, tmp_path):
    """In a group of one rank the collectives are the stacked means of
    one upload, and the sharded round is the stacked round at K=1."""
    zs, cfg, st = setup["zs"], setup["cfg"], setup["st"]
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        assert (axis_size(), axis_index()) == (1, 0)
        rng = np.random.RandomState(3)
        z = torch.from_numpy((rng.rand(100) < 0.5).astype(np.float32))
        lanes = tbp.pack_mask(z)
        psum = tprot.get_transport("psum_u32")
        want = psum.aggregate_stacked_packed(lanes[None], 100)
        assert torch.equal(psum.aggregate_collective_packed(lanes, 100), want)
        assert torch.equal(psum.aggregate_collective(z), want)
        assert torch.equal(
            tprot.get_transport("mean").aggregate_collective(z),
            tprot.get_transport("mean").aggregate_stacked(z[None]))
        d = torch.from_numpy(rng.randn(7).astype(np.float32))
        assert torch.equal(tprot.pmean(d), tprot.mean0(d[None]))
        b = {n: v[:1] for n, v in setup["batches"][0].items()}
        one, m1 = tfed.sharded_client_update(
            zs, st, tmlp.mlp_loss, {n: v[0] for n, v in b.items()}, KEY,
            cfg, round_index=ROUND, device="cpu")
        ref, mr = tfed.federated_round(zs, st, tmlp.mlp_loss, b, KEY, cfg,
                                       round_index=ROUND, device="cpu")
        assert torch.equal(m1["loss"], mr["loss"])
        for part in ("scores", "dense"):
            for p in ref[part]:
                assert torch.equal(one[part][p], ref[part][p])
    finally:
        dist.destroy_process_group()


def test_what_raises(setup):
    zs, cfg, st = setup["zs"], setup["cfg"], setup["st"]
    b = {n: v[0] for n, v in setup["batches"][0].items()}
    # the participation arguments are ported: outside a process group
    # the round has no ranks to meet
    for kw in (dict(client_id=1), dict(weight=2)):
        with pytest.raises(ValueError, match="process group"):
            tfed.sharded_client_update(zs, st, tmlp.mlp_loss, b, KEY, cfg,
                                       device="cpu", **kw)
    ag = tprot.get_transport("allgather_packed")  # ported
    assert ag.packed_wire and ag.name == "allgather_packed"
    with pytest.raises(ValueError, match="world"):
        run_ranks(ranks_mod.rank_sleeps, 0, (0,))


def test_runner_raises_when_a_rank_fails_or_overruns(tmp_path):
    """A rank that raises makes the runner raise at once with its
    traceback, though its peer waits in a collective; a run that
    outlasts its timeout raises too; no rank is left running."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(ranks_mod.rank_fails_on_one, 2, timeout=60.0,
                  tmpdir=str(tmp_path))
    with pytest.raises(TimeoutError):
        run_ranks(ranks_mod.rank_sleeps, 1, (60,), timeout=1.0,
                  tmpdir=str(tmp_path))
    assert not mp.active_children()


# -- the ranks' results --------------------------------------------------------

def test_rank_words_are_the_stacked_rounds_and_jaxs(ranks):
    words = [r["word"] for r in ranks]
    assert [r["rank"] for r in ranks] == list(range(K))
    assert [r["world"] for r in ranks] == [K] * K
    assert words == [ts.fold_word(KEY, ROUND, k) for k in range(K)]
    np.testing.assert_array_equal(
        np.asarray(words, np.uint32),
        _np(js.fold_word(np.uint32(KEY), np.uint32(ROUND),
                         jnp.arange(K, dtype=jnp.uint32))))


def test_collective_means_are_the_stacked_means_of_the_same_uploads(
        setup, ranks):
    zs, cfg = setup["zs"], setup["cfg"]
    psum = tprot.get_transport("psum_u32")
    mean = tprot.get_transport("mean")
    agg = {}
    for p, s in zs.specs.items():
        lanes = torch.from_numpy(np.stack([r["upload"][p] for r in ranks]))
        agg[p] = psum.aggregate_stacked_packed(lanes, s.n)
        want_m = mean.aggregate_stacked(tbp.unpack_mask(lanes, s.n))
        assert torch.equal(agg[p], want_m)
        for r in ranks:
            for form in ("packed", "psum", "mean", "allgather",
                         "allgather_z"):
                np.testing.assert_array_equal(r["agg"][p][form],
                                              agg[p].numpy())
    words = tfed._encode_scores(zs, cfg, agg, KEY, ROUND)
    for r in ranks:
        for p in zs.specs:
            np.testing.assert_array_equal(r["round"][0]["scores"][p],
                                          words[p].numpy())


def test_every_rank_ends_with_the_same_state_and_metrics(ranks):
    for key in ("round", "round_mean", "round_allgather", "fit"):
        for r in ranks[1:]:
            _eq_state(r[key][0], ranks[0][key][0])
            for name, v in ranks[0][key][1].items():
                np.testing.assert_array_equal(r[key][1][name], v)


def test_sharded_round_is_the_stacked_round(setup, ranks):
    """Round 0's uploads and u8 words bitwise the port's stacked
    round's; the dense leaves and loss allclose (another sum order)."""
    zs = setup["zs"]
    r0 = ranks[0]
    # the precondition: a batched product equals the per-client one at
    # every layer's shapes here (not so at MNISTFC's 784x300, K=10)
    assert r0["bmm_equals_mm"] == [True] * (len(tmlp.SMALL_DIMS) - 1)
    for p in zs.specs:
        np.testing.assert_array_equal(
            np.stack([r["upload"][p] for r in ranks]),
            r0["stacked_upload"][p])
    state, met = r0["round"]
    s_state, s_met = r0["stacked"]
    for p in zs.specs:
        np.testing.assert_array_equal(state["scores"][p],
                                      s_state["scores"][p])
    for p in zs.dense_paths:
        np.testing.assert_allclose(state["dense"][p], s_state["dense"][p],
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(met["loss"], s_met["loss"], rtol=1e-6)
    for name in tfed.WIRE_METRIC_KEYS:
        assert met[name] == s_met[name]


def test_transports_and_kernel_wrappers_give_the_same_round(setup, ranks):
    """mean_f32, psum_u32 and allgather_packed give the same round; so
    does the round through the kernel wrappers, which each round calls
    3E times for kernels 7 and 5 and 3 times for kernel 9, and never a
    batched one."""
    want = {name: 0 for name in tqr.LAUNCHES}
    want.update({"qz_sample_reconstruct_fwd": 3 * E,
                 "qz_reconstruct_bwd_plan": 3 * E,
                 "qz_sample_pack_fwd": 3})
    for r in ranks:
        _eq_state(r["round_mean"][0], r["round"][0])
        _eq_state(r["round_allgather"][0], r["round"][0])
        assert r["round_mean"][1]["uplink_bytes_per_client"] > \
            r["round"][1]["uplink_bytes_per_client"] == \
            r["round_allgather"][1]["uplink_bytes_per_client"]
        _eq_state(r["round_via_wrappers"], r["round"][0])
        assert r["wrapper_calls"] == want


def test_sharded_fit_equals_sequential_updates(ranks):
    for r in ranks:
        _eq_state(r["fit"][0], r["seq"][0])
        for i, m in enumerate(r["seq"][1]):
            for name, v in m.items():
                assert r["fit"][1][name][i] == v
        assert r["fit"][1]["loss"].shape == (len(FIT_WORDS),)
        assert r["fit"][0]["scores"]["layer0/kernel"].dtype == np.uint8


def test_metrics_count_the_group_not_the_config(setup, ranks):
    """K is the group's size (3), not ``cfg.num_clients`` (10 in the
    ranks): the JAX package's ``test_sharded_metrics_use_mesh_size``."""
    zs = setup["zs"]
    met = ranks[0]["round"][1]
    want = tfed.round_wire_report(zs, "psum_u32", K, downlink="u8")
    for name in tfed.WIRE_METRIC_KEYS:
        assert met[name] == want[name]
    assert met["cohort_size"] == met["num_participating"] == float(K)


def test_sharded_round_against_jax_vmap_round(setup, ranks):
    """Round 0 from the JAX package's state against its ``vmap`` round
    under ``jax.jit`` at the same key and round."""
    zs, jzs, jcfg = setup["zs"], setup["jzs"], setup["jcfg"]
    b = setup["batches"][0]
    jnew, jmet = jax.jit(lambda s, bb: jfed.federated_round(
        jzs, s, jmlp.mlp_loss, bb, np.uint32(KEY), jcfg,
        round_index=ROUND))(setup["jst"],
                            {n: jnp.asarray(v) for n, v in b.items()})
    state, met = ranks[0]["round"]
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    for name in tfed.WIRE_METRIC_KEYS:
        assert met[name] == float(jmet[name])
    for p in zs.dense_paths:
        np.testing.assert_allclose(state["dense"][p], _np(jnew["dense"][p]),
                                   rtol=0, atol=DENSE_ATOL)
    differ = sum(int((state["scores"][p] != _np(jnew["scores"][p])).sum())
                 for p in zs.specs)
    assert differ <= MAX_FLIP_SHARE * K * zs.n_total


def test_a_converted_jax_state_runs_the_sharded_round(setup, ranks):
    """The ranks' input was ``convert``'s carry of the JAX state: equal
    to the port's own encoding, and the round's output is u8 words of
    every leaf's length."""
    zs, st = convert.federated_state_from_jax(setup["jzs"], setup["jst"],
                                              device="cpu")
    for p in zs.specs:
        assert torch.equal(st["scores"][p], setup["st"]["scores"][p])
        out = ranks[0]["round"][0]["scores"][p]
        assert out.dtype == np.uint8 and out.shape == (zs.specs[p].n,)
    assert np.isfinite(ranks[0]["round"][1]["loss"])
