"""The port's model axis in a round: grids of gloo ranks against the
stacked round, the data-axis round and JAX's.

At the ``test_torch_federated.py`` setup (SMALL_DIMS 784-20-20-10,
E=2 local steps, batch 8, compression 8, d=10, window 128, psum_u32
uplink, u8 downlink) with each zampled leaf's major axis where
``launch.sharding.param_spec`` puts the model axis.  Four gloo ranks
start once for the module (``_torch_model_axis_ranks.rank_grid`` runs
every rank-side check): first a grid of 2 data x 2 model ranks, one
client a data index and each leaf split over its model group, then the
same ranks as one model group of 4 running a stacked K=3 round.

A local step consumes each sharded leaf as the rank's block (the
partitioned consumers of ``models.common``): a column block's products
give its output columns, a row block's partial products meet in an
all-reduce.  Sums then split over ranks round otherwise than the
whole products, as GSPMD's do, so the grid is held to the stacked and
the data-axis rounds by bound: losses within ``GRID_LOSS_RTOL``, dense
leaves within ``DENSE_ATOL``, u8 words differing at no more than
``MAX_FLIP_SHARE`` of ``n_total``, counters exact.  By bits where the
products agree: after asserting that at these shapes a column block's
products equal the whole products' columns, the partitioned MLP's loss
and last layer's cotangents equal the unsharded ones.  The reduced
qwen2-0.5b (f32) on the grid (heads whole on each rank) and on the
model group of 4 (KV heads split mid-head): its loss within
``GRID_LOSS_RTOL`` and every leaf's cotangent block within
``GRAD_RTOL`` of that leaf's largest unsharded cotangent.  No matrix
leaf is gathered whole.  The frontier's widths from slices equal the
whole tensors' by bits, and a frontier round on the grid gives the
stacked round's and JAX's widths.  Against JAX's ``vmap`` round on the
same sharded specs (its reference path needs no mesh):
``test_torch_federated.py``'s tolerances.
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
from repro_torch.models.common import matrix_gathers
from test_torch_federated import (DENSE_ATOL, FC, LOSS_RTOL, MAX_FLIP_SHARE,
                                  ZC, _jtemplate)
from test_torch_federated import setup  # noqa: F401  (a fixture)

import _torch_model_axis_ranks as ranks_mod

GRID_LOSS_RTOL = 1e-5  # partitioned sums against whole ones, f32
GRAD_RTOL = 1e-5  # of a leaf's largest cotangent (2.5e-6 seen)
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


def _jax_specs(zs):
    """JAX's spec set for the grid, built by JAX's own ``param_spec`` on
    a 2 x 2 stub mesh; the port's ``zs`` must be its twin."""
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
    return jzs


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


def _close(zs, a, b):
    """A partitioned round's state against a reference's, by bound."""
    assert a["scores"].keys() == b["scores"].keys()
    assert a["dense"].keys() == b["dense"].keys()
    for p in a["dense"]:
        np.testing.assert_allclose(a["dense"][p], b["dense"][p], rtol=0,
                                   atol=DENSE_ATOL)
    differ = sum(int((a["scores"][p] != b["scores"][p]).sum())
                 for p in a["scores"])
    assert differ <= MAX_FLIP_SHARE * zs.n_total


def _metrics_close(got, want):
    for name, v in want.items():
        if name == "loss":
            np.testing.assert_allclose(got[name], v, rtol=GRID_LOSS_RTOL)
        else:
            np.testing.assert_array_equal(got[name], v)


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
    among them) within the partitioned round's bounds of the stacked
    round's, for a plain round and a faulted weighted round, on both
    data ranks; the counters exact."""
    zs, ranks = grid["zs"], grid["ranks"]
    ref = ranks[0]
    assert ref["bmm_equals_mm"] == [True, True, True]
    want = {"round": ref["stacked"], "faulted": ref["stacked_faulted"]}[key]
    for d in (0, 1):
        _close(zs, _joined(zs, [ranks[2 * d][key][0],
                                ranks[2 * d + 1][key][0]]), want[0])
    for r in ranks:
        _metrics_close(r[key][1], want[1])
        # the model ranks of a client agree by bits
        np.testing.assert_array_equal(r[key][1]["loss"],
                                      ranks[2 * (r["data"])][key][1]["loss"])
    if key == "faulted":
        assert ranks[0][key][1]["num_corrupt"] == 1.0
        assert ranks[0][key][1]["num_participating"] == 1.0


def test_grid_round_is_the_data_axis_round_by_bits(grid):
    """The partitioned MLP against the unsharded one by bits where the
    products agree (asserted first: at these shapes a column block's
    forward and backward products equal the whole products' columns):
    the loss and the last layer's cotangents; the other cotangents
    within ``GRAD_RTOL``.  Then the grid's round against the same clients
    run one at a time, as ranks of a data axis alone run them: within
    the partitioned round's bounds."""
    zs, ranks = grid["zs"], grid["ranks"]
    for r in ranks:
        mlp = r["mlp"]
        assert mlp["products_equal"] == [True, True, True]
        np.testing.assert_array_equal(*mlp["loss"])
        for p, (want, got) in mlp["grads"].items():
            if p.startswith("layer2/"):
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=GRAD_RTOL * np.abs(want).max())
    want, loss = ranks[0]["per_client"]
    for d in (0, 1):
        got = _joined(zs, [ranks[2 * d]["round"][0],
                           ranks[2 * d + 1]["round"][0]])
        _close(zs, got, want)
        for r in ranks[2 * d:2 * d + 2]:
            np.testing.assert_allclose(r["round"][1]["loss"], loss,
                                       rtol=GRID_LOSS_RTOL)


@pytest.mark.parametrize("key", ["lm_grid", "lm_line", "lm_flash"])
def test_reduced_qwen2_blocks_against_unsharded(grid, key):
    """The reduced qwen2-0.5b's K=2 loss and every leaf's cotangent block
    through the partitioned consumers against the unsharded forward's:
    on the grid's model groups of 2 (whole heads a rank) and on the
    model group of 4 (its 2 KV heads split mid-head); ``embed`` by
    vocabulary rows, ``lm_head`` by columns, the k/v biases replicated
    (as full-width qwen2-0.5b's, below ``min_size``); and one layer at
    ``FLASH_THRESHOLD`` tokens, the blockwise attention on each rank's
    head block, on data index 0's model group."""
    ms = 4 if key == "lm_line" else 2
    ranks = [r for r in grid["ranks"] if key in r]
    assert len(ranks) == (2 if key == "lm_flash" else 4)
    for r in ranks:
        res = r[key]
        assert res["dims"]["embed"] == 0 and res["dims"]["lm_head"] == 1
        assert res["dims"]["blocks/attn/wo"] == 1
        assert res["dims"]["blocks/mlp/down"] == 1
        np.testing.assert_allclose(res["loss"][1], res["loss"][0],
                                   rtol=GRID_LOSS_RTOL)
        for p, (want, got) in res["grads"].items():
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=GRAD_RTOL * np.abs(want).max())
        # the replicated k/v biases' cotangent blocks are joined once a
        # step; the head-parallel attention gathers no activation, split
        # heads gather q, k and v a layer and join wo's input cotangent
        gathers = res["counts"][0].get("all_gather", 0)
        assert gathers == 2 + (0 if ms == 2 else 4 * 2)


@pytest.mark.parametrize("key", ["round_counts", "mlp", "lm_grid",
                                 "lm_line", "lm_flash"])
def test_no_matrix_leaf_is_gathered(grid, key):
    """Whole-leaf gathers of a local step: none of a matrix leaf (MNISTFC
    has no other sharded leaf; the decoder gathers its two norm scales),
    the activations' all-reduces counted instead."""
    for r in [r for r in grid["ranks"] if key in r]:
        counts, gathered = (r[key] if key == "round_counts"
                            else r[key]["counts"])
        assert matrix_gathers(gathered) == 0
        if key.startswith("lm"):
            assert gathered == {"blocks/ln1": 1, "blocks/ln2": 1}
            # a layer's 2 forward and 2 backward, the embedding, the CE's
            # 3 and lm_head's input cotangent
            assert counts["all_reduce"] == r[key]["layers"] * 4 + 1 + 3 + 1
        else:
            assert gathered == {}
            assert counts["all_reduce"] > 0


def test_frontier_on_the_grid(setup, grid):
    """The frontier's widths from each rank's slices (their exact flip
    sums meeting over the model group) equal the whole tensors' by bits;
    a frontier round on the grid gives the stacked round's widths and
    JAX's."""
    ranks = grid["ranks"]
    for r in ranks:
        np.testing.assert_array_equal(*r["frontier_widths"])
        np.testing.assert_array_equal(r["frontier"],
                                      ranks[0]["frontier_stacked"])
    zs = grid["zs"]
    jzs = _jax_specs(zs)
    jcfg = jfed.FederatedConfig(**FC, downlink_schedule="frontier")
    jst = jfed.encode_state(jzs, jcfg, {
        "scores": {p: jnp.asarray(v) for p, v in grid["scores"].items()},
        "dense": {p: jnp.asarray(v) for p, v in grid["dense"].items()}}, 5)
    b = {n: jnp.asarray(v[:2]) for n, v in setup["batches"][0].items()}
    jnew, _ = jax.jit(lambda s, bb: jfed.federated_round(
        jzs, s, jmlp.mlp_loss, bb, np.uint32(KEY), jcfg,
        round_index=ROUND))(jst, b)
    np.testing.assert_array_equal(np.asarray(jnew["downlink_b"]),
                                  ranks[0]["frontier"])


def test_gather_major_and_its_backward(grid):
    for r in grid["ranks"]:
        whole, grad = r["gather"]
        np.testing.assert_array_equal(whole, np.concatenate(
            [np.arange(6.0).reshape(2, 3) + 10 * m for m in (0, 1)]))
        np.testing.assert_array_equal(
            grad, np.arange(12.0).reshape(4, 3)[2 * r["model"]:
                                                2 * r["model"] + 2])


def test_a_stacked_round_on_a_model_group_of_four(grid):
    """A K=3 round on a model group of 4 (layer 2's kernel row-parallel)
    within the partitioned round's bounds of the same round without a
    model axis."""
    zs4, ranks = grid["zs4"], grid["ranks"]
    assert {s.shard_count for s in zs4.specs.values()} == {4}
    assert {s.major_axis for s in zs4.specs.values()} == {0, 1}
    want_state, want_met = ranks[0]["line_stacked"]
    _close(zs4, _joined(zs4, [r["line"][0] for r in ranks]), want_state)
    for r in ranks:
        _metrics_close(r["line"][1], want_met)
        np.testing.assert_array_equal(r["line"][1]["loss"],
                                      ranks[0]["line"][1]["loss"])


def test_grid_round_against_jax_vmap_round(setup, grid):
    """The grid's round against JAX's ``vmap`` round on the same sharded
    specs, built by JAX's own ``param_spec`` on a 2 x 2 stub mesh."""
    zs = grid["zs"]
    jzs = _jax_specs(zs)
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
