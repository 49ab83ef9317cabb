"""The port's model axis in a round: grids of gloo ranks against the
stacked round and JAX's.

At the ``test_torch_federated.py`` setup (SMALL_DIMS 784-20-20-10,
E=2 local steps, batch 8, compression 8, d=10, window 128, psum_u32
uplink, u8 downlink) with each zampled leaf's major axis where
``launch.sharding.param_spec`` puts the model axis.  Four gloo ranks
start once for the module (``_torch_model_axis_ranks.rank_grid`` runs
every rank-side check): first a grid of 2 data x 2 model ranks, one
client a data index and each leaf split over its model group, then the
same ranks as one model group of 4 running a stacked K=3 round.

Bitwise: the grid's state (its slices joined), loss and words against
the port's stacked K=2 round, after asserting that at these shapes
``bmm`` equals the per-client ``mm`` (a sum of two is the same in
either order, so the dense mean and the loss agree by bits too); a
faulted, weighted grid round against the stacked participation round;
``gather_major`` and its
backward; the model group's stacked K=3 round against the same round
without a model axis.  Against JAX's ``vmap`` round on the same sharded
specs (its reference path needs no mesh): ``test_torch_federated.py``'s
tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import federated as jfed, zampling as jz
from repro.launch import sharding as jshp
from repro.models import mlp as jmlp
from repro_torch import convert
from repro_torch.comm.shardmap import run_ranks
from repro_torch.core import federated as tfed
from repro_torch.fault import plan as tplan
from repro_torch.launch.mesh import Mesh
from test_torch_federated import (DENSE_ATOL, FC, LOSS_RTOL, MAX_FLIP_SHARE,
                                  ZC, _jtemplate)
from test_torch_federated import setup  # noqa: F401  (a fixture)

import _torch_model_axis_ranks as ranks_mod

KEY, ROUND = 7, 2
RANK_TIMEOUT = 120.0  # seconds; the ranks take a few on a CPU
GRID = Mesh(("data", "model"), (2, 2))
IDS, WEIGHTS = [3, 8], [2, 5]


class _StubMesh:
    """What JAX's sharding rules read of a mesh."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


def _encoded(zs, rng):
    cfg = tfed.FederatedConfig(**FC)
    scores = {p: rng.rand(s.n).astype(np.float32) for p, s in zs.specs.items()}
    dense = {p: (0.1 * rng.randn(*zs.template[p].shape)).astype(np.float32)
             for p in zs.dense_paths}
    st = tfed.encode_state(zs, cfg, {"scores": scores, "dense": dense}, 5,
                           device="cpu")
    return {part: {p: v.numpy() for p, v in st[part].items()}
            for part in ("scores", "dense")}, scores, dense


def _plan():
    """A fault plan under which, at round ROUND, one of the two clients
    IDS uploads a corrupt payload and the other arrives whole."""
    for seed in range(200):
        plan = tplan.FaultPlan(corrupt=0.5, seed=seed)
        codes = tplan.draw_faults(plan, ROUND, IDS).tolist()
        if sorted(codes) == [tplan.OK, tplan.CORRUPT]:
            return dict(corrupt=0.5, seed=seed)
    raise AssertionError("no seed corrupts one client of two")


@pytest.fixture(scope="module")
def grid(setup, tmp_path_factory):
    rng = np.random.RandomState(4)
    zs = ranks_mod.grid_specs(ZC, GRID)
    zs4 = ranks_mod.grid_specs(ZC, Mesh(("data", "model"), (1, 4)))
    state, scores, dense = _encoded(zs, rng)
    state4, _, _ = _encoded(zs4, rng)
    args = {"zc": ZC, "fc": FC, "key": KEY, "round": ROUND,
            "state": state, "state4": state4,
            "batches": setup["batches"], "ids": IDS, "weights": WEIGHTS,
            "plan": _plan()}
    out = run_ranks(ranks_mod.rank_grid, 4, (args,), mesh=GRID,
                    timeout=RANK_TIMEOUT,
                    tmpdir=str(tmp_path_factory.mktemp("grid")))
    return dict(zs=zs, zs4=zs4, ranks=out, scores=scores, dense=dense)


def _joined(zs, rank_states):
    """The whole state from the model ranks' (slices, rank 0 first)."""
    return convert.from_model_ranks(zs, rank_states)


def _eq(a, b):
    for part in ("scores", "dense"):
        assert a[part].keys() == b[part].keys()
        for p in a[part]:
            np.testing.assert_array_equal(a[part][p], b[part][p])


def test_the_grid_splits_every_leaf_over_its_model_group(grid):
    zs, ranks = grid["zs"], grid["ranks"]
    assert [(r["data"], r["model"]) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert {s.shard_count for s in zs.specs.values()} == {2}
    assert {s.major_axis for s in zs.specs.values()} == {1}
    for r in ranks:
        for p, s in zs.specs.items():
            assert r["round"][0]["scores"][p].shape == (s.n // 2,)


@pytest.mark.parametrize("key", ["round", "faulted"])
def test_grid_rounds_are_the_stacked_rounds(grid, key):
    """Joined slices (the u8 words), dense leaves and metrics (the loss
    among them) bitwise the stacked round's, for a plain round and a
    faulted weighted round, on both data ranks."""
    zs, ranks = grid["zs"], grid["ranks"]
    ref = ranks[0]
    assert ref["bmm_equals_mm"] == [True, True, True]
    want = {"round": ref["stacked"], "faulted": ref["stacked_faulted"]}[key]
    for d in (0, 1):
        _eq(_joined(zs, [ranks[2 * d][key][0], ranks[2 * d + 1][key][0]]),
            want[0])
    for r in ranks:
        for name, v in want[1].items():
            np.testing.assert_array_equal(r[key][1][name], v)
    if key == "faulted":
        assert ranks[0][key][1]["num_corrupt"] == 1.0
        assert ranks[0][key][1]["num_participating"] == 1.0


def test_grid_round_is_the_data_axis_round_by_bits(grid):
    """The grid's state and loss bitwise those of the same clients run
    one at a time, as ranks of a data axis alone run them: the model
    axis changes no bit."""
    zs, ranks = grid["zs"], grid["ranks"]
    want, loss = ranks[0]["per_client"]
    for d in (0, 1):
        got = _joined(zs, [ranks[2 * d]["round"][0],
                           ranks[2 * d + 1]["round"][0]])
        _eq(got, want)
        for r in ranks[2 * d:2 * d + 2]:
            np.testing.assert_array_equal(r["round"][1]["loss"], loss)


def test_gather_major_and_its_backward(grid):
    for r in grid["ranks"]:
        whole, grad = r["gather"]
        np.testing.assert_array_equal(whole, np.concatenate(
            [np.arange(6.0).reshape(2, 3) + 10 * m for m in (0, 1)]))
        np.testing.assert_array_equal(
            grad, np.arange(12.0).reshape(4, 3)[2 * r["model"]:
                                                2 * r["model"] + 2])


def test_a_stacked_round_on_a_model_group_of_four(grid):
    zs4, ranks = grid["zs4"], grid["ranks"]
    assert {s.shard_count for s in zs4.specs.values()} == {4}
    assert {s.major_axis for s in zs4.specs.values()} == {0, 1}
    want_state, want_met = ranks[0]["line_stacked"]
    _eq(_joined(zs4, [r["line"][0] for r in ranks]), want_state)
    for r in ranks:
        for name, v in want_met.items():
            np.testing.assert_array_equal(r["line"][1][name], v)


def test_grid_round_against_jax_vmap_round(setup, grid):
    """The grid's round against JAX's ``vmap`` round on the same sharded
    specs, built by JAX's own ``param_spec`` on a 2 x 2 stub mesh."""
    zs = grid["zs"]
    stub = _StubMesh(("data", "model"), (2, 2))

    def plan(path, shape):
        for i, axis in enumerate(jshp.param_spec(path, shape, stub)):
            if axis == "model":
                return i
        return None

    jzs = jz.build_specs(_jtemplate(jmlp.SMALL_DIMS),
                         jz.ZamplingConfig(**ZC, shard_align=2),
                         shard_plan_fn=plan)
    assert convert.zspecs_from_jax(jzs).specs == zs.specs
    jcfg = jfed.FederatedConfig(**FC)
    jst = jfed.encode_state(jzs, jcfg, {
        "scores": {p: jnp.asarray(v) for p, v in grid["scores"].items()},
        "dense": {p: jnp.asarray(v) for p, v in grid["dense"].items()}}, 5)
    b = {n: jnp.asarray(v[:2]) for n, v in setup["batches"][0].items()}
    jnew, jmet = jax.jit(lambda s, bb: jfed.federated_round(
        jzs, s, jmlp.mlp_loss, bb, np.uint32(KEY), jcfg,
        round_index=ROUND))(jst, b)
    ranks = grid["ranks"]
    state = _joined(zs, [ranks[0]["round"][0], ranks[1]["round"][0]])
    met = ranks[0]["round"][1]
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    for p in zs.dense_paths:
        np.testing.assert_allclose(state["dense"][p],
                                   np.asarray(jnew["dense"][p]), rtol=0,
                                   atol=DENSE_ATOL)
    differ = sum(int((state["scores"][p]
                      != np.asarray(jnew["scores"][p])).sum())
                 for p in zs.specs)
    assert differ <= MAX_FLIP_SHARE * 2 * zs.n_total
