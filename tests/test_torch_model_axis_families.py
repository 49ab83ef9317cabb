"""The MoE, SSM, hybrid and enc-dec families on a model axis: their
partitioned consumers against the data-axis path and JAX's loss.

Four gloo ranks start once for the module, a 2 x 2 grid
(``_torch_model_axis_ranks.rank_families``).  Each data index's model
group of 2 runs its share of the cases, one local step of one client at
``reduced()`` size (f32, batch 2, sequence 16; compression 8 and d=2,
``min_size`` per case so that the placements below are zampled):

 - olmoe-1b-7b: experts split on E, the router a column block over E;
 - the reduced mixtral-8x7b with 3 experts (``moe-ffn``): experts split
   on F (``gate``/``up`` columns, ``down`` rows), the router a row block
   over D;
 - mamba2-1.3b: ``in_proj`` and ``out_proj`` column blocks, the SSD on
   each rank's 8 of 16 heads, ``A_log``/``D``/``dt_bias`` replicated,
   ``norm`` a block, the conv taps gathered whole;
 - zamba2-7b: its mamba layers likewise with ``A_log``/``D``/``dt_bias``
   blocks and ``ln`` gathered whole, and the shared attention block;
 - seamless-m4t-medium: the encoder, the decoder's self and cross
   attention (head-parallel), ``dec_embed`` by vocabulary rows.

Each case holds the partitioned step's loss and the gradient of every
sharded leaf's scores (and every dense leaf) against the same step on
the data axis alone (whole leaves, the same specs), after asserting
that at its shapes a column block's products equal the whole products'
columns: the losses within ``LOSS_RTOL``, the gradients within
``GRAD_RTOL`` of the leaf's largest (split sums round otherwise, as
GSPMD's do; measured up to 1.3e-7 and 9.5e-6).  A gradient trap (a
replicated value used rank-locally without summing its cotangent)
loses the other rank's share: an error of order 1.  Where the router is
a column block, its gathered logits and so the routing (dispatch,
combine, picks) equal the whole router's by bits; a row block's logits
are a split sum, held within ``LOGITS_RTOL``.  The whole step's loss is
held to JAX's ``loss_fn`` on the same leaves at
``test_torch_families.py``'s tolerance.  No matrix leaf is gathered
whole, and the collectives equal the dry run's count at the test's
shape (``launch.dryrun.consumer_collectives``).

Then the grid runs a round of zamba2-7b (a client a data index) against
its data-axis ranks on the same specs: the loss within ``LOSS_RTOL``,
the new scores differing at no more than ``FLIP_SHARE`` of n_total, the
dense leaves within ``DENSE_ATOL``, the collectives the dry run's on the
2 x 2 mesh.  The unit tests at the end need no ranks: the whole-gather
counter, ``make_batch``'s device and the dry run of every arch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.model import build_model as jbuild, loss_fn as jloss
from repro_torch.comm.shardmap import run_ranks
from repro_torch.configs import ARCHS, InputShape, get_arch, get_shape
from repro_torch.core.zampling import flatten
from repro_torch.launch import dryrun, input_specs
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.sharding import model_axis_of, param_spec
from repro_torch.models.common import MATRIX_LEAVES, matrix_gathers
from repro_torch.models.model import param_template
from _torch_families_common import _nest

import _torch_model_axis_ranks as ranks_mod

ZC = dict(compression=8, d=2)  # d=2: the plain reconstruction stays cheap
B, S = 2, 16
LOSS_RTOL = 1e-5  # measured within 1.3e-7 (an ulp)
GRAD_RTOL = 5e-5  # of a leaf's largest gradient; measured up to 9.5e-6
LOGITS_RTOL = 1e-5  # a row block's split logits; of the largest
JAX_LOSS_RTOL = 1e-5  # test_torch_families.py's LOSS_RTOL
FLIP_SHARE = 1e-3  # grid round: differing scores, of n_total
DENSE_ATOL = 1e-6  # grid round: dense leaves after one step
RANK_TIMEOUT = 300.0
GRID = Mesh(("data", "model"), (2, 2))
CASES = sorted(ranks_mod.FAMILY_CASES)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(ranks_mod.rank_families, GRID.size, (ZC,), mesh=GRID,
                     timeout=RANK_TIMEOUT,
                     tmpdir=str(tmp_path_factory.mktemp("families")))


def _case(ranks, name):
    """The two ranks of the model group that ran ``name``."""
    got = [r[name] for r in ranks if name in r]
    assert len(got) == 2
    return got


def _specs(name, mesh):
    return ranks_mod.family_specs(ranks_mod.family_config(name), mesh,
                                  ranks_mod.family_zc(name, ZC))


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_the_cases_take_the_placements_param_spec_gives():
    line = Mesh(("data", "model"), (1, 2))
    want = {
        "olmoe-1b-7b": {"blocks/moe/gate": 1, "blocks/moe/up": 1,
                        "blocks/moe/down": 1, "blocks/moe/router": 2},
        "moe-ffn": {"blocks/moe/gate": 3, "blocks/moe/up": 3,
                    "blocks/moe/down": 2, "blocks/moe/router": 1},
        "mamba2-1.3b": {"blocks/ssm/in_proj": 2, "blocks/ssm/out_proj": 2,
                        "blocks/ssm/norm": 1, "blocks/ssm/conv_w": 2},
        "zamba2-7b": {"mamba/ssm/A_log": 1, "mamba/ssm/D": 1,
                      "mamba/ssm/dt_bias": 1, "mamba/ln": 1,
                      "shared_attn/attn/wo": 0},
        "seamless-m4t-medium": {"dec_embed": 0, "dec_blocks/cross/wk": 2,
                                "dec_blocks/cross/wo": 1},
    }
    for name, axes in want.items():
        zs = _specs(name, line)
        for p, axis in axes.items():
            assert zs.specs[p].shard_count == 2, (name, p)
            assert zs.specs[p].major_axis == axis, (name, p)
    assert "blocks/ssm/A_log" in _specs("mamba2-1.3b", line).dense_paths


@pytest.mark.parametrize("name", CASES)
def test_partitioned_step_against_the_data_axis(ranks, name):
    for r in _case(ranks, name):
        assert r["products_equal"] and all(r["products_equal"])
        np.testing.assert_allclose(r["loss"][1], r["loss"][0],
                                   rtol=LOSS_RTOL)
        for part in ("scores", "dense"):
            for p, (want, got) in r[part].items():
                assert got.shape == want.shape, p
                assert np.isfinite(got).all(), p
                assert _rel(got, want) <= GRAD_RTOL, (part, p,
                                                      _rel(got, want))


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "moe-ffn"])
def test_moe_routing_from_the_partitioned_router(ranks, name):
    """A column block's gathered logits are the whole router's columns
    by bits (asserted first), so the routing is the same bits; a row
    block's logits are a split sum, within LOGITS_RTOL."""
    for r in _case(ranks, name):
        rt = r["routing"]
        if name == "olmoe-1b-7b":
            assert rt["logits_equal"]
            assert rt["routing_equal"]
        else:
            assert rt["logits_err"] <= LOGITS_RTOL


def _per_step(name, mesh, zs, b=B):
    cfg = ranks_mod.family_config(name)
    placed = {p: model_axis_of(param_spec(p, sp.shape, mesh))
              for p, sp in zs.specs.items()}
    return dryrun.consumer_collectives(
        cfg, InputShape("t", S, b * mesh.shape[0], "train"), mesh, zs,
        placed)


@pytest.mark.parametrize("name", CASES)
def test_no_matrix_gather_and_the_dry_runs_count(ranks, name):
    line = Mesh(("data", "model"), (1, 2))
    zs = _specs(name, line)
    want = dryrun.as_counts(_per_step(name, line, zs))
    for r in _case(ranks, name):
        counts, gathered = r["counts"]
        assert matrix_gathers(gathered) == 0
        assert all(n == 1 for n in gathered.values())
        assert counts == want


@pytest.mark.parametrize("name", CASES)
def test_whole_step_against_jax_loss(ranks, name):
    cfg = ranks_mod.family_config(name)
    jcfg = jreg.get_arch("mixtral-8x7b" if name == "moe-ffn"
                         else name).reduced()
    if name == "moe-ffn":
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, num_experts=cfg.moe.num_experts))
    jm = jbuild(jcfg)
    r = _case(ranks, name)[0]
    params = _nest({p: jnp.asarray(v) for p, v in r["whole"].items()})
    batch = {n: jnp.asarray(v) for n, v in r["batch"].items()}
    want = float(jax.jit(lambda pp, bb: jloss(jm, pp, bb))(params, batch))
    np.testing.assert_allclose(float(r["loss"][0]), want,
                               rtol=JAX_LOSS_RTOL)


def test_grid_round_against_its_data_axis_ranks(ranks):
    """A round of zamba2-7b on the 2 x 2 grid: each data index's model
    slices joined against that index's data-axis rank."""
    name = ranks_mod.GRID_CASE
    zs = _specs(name, GRID)
    res = [r["grid"] for r in ranks]
    ref = {r["data"]: r["data_axis"] for r in res if "data_axis" in r}
    assert sorted(ref) == [0, 1]
    for r in res:
        want = ref[r["data"]]
        np.testing.assert_allclose(r["grid"]["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        for p, v in r["grid"]["dense"].items():
            np.testing.assert_allclose(v, want["dense"][p], rtol=0,
                                       atol=DENSE_ATOL)
    differ = 0
    for d in (0, 1):
        parts = sorted((r for r in res if r["data"] == d),
                       key=lambda r: r["model"])
        for p, spec in zs.specs.items():
            got = np.concatenate([r["grid"]["scores"][p] for r in parts]
                                 if spec.shard_count > 1
                                 else [parts[0]["grid"]["scores"][p]])
            assert got.shape == ref[d]["scores"][p].shape
            differ += int((got != ref[d]["scores"][p]).sum())
    assert differ <= FLIP_SHARE * 2 * zs.n_total
    want = dryrun.as_counts(_per_step(name, GRID, zs))
    for r in res:
        counts, gathered = r["counts"]
        assert matrix_gathers(gathered) == 0
        assert counts == want


# ---------------------------------------------------------------------------
# the repairs, without ranks
# ---------------------------------------------------------------------------

def test_matrix_leaves_count_every_familys_matrices():
    """A whole gather of any matrix leaf of any family counts; the norm
    scales and the SSM's conv taps and per-head vectors do not."""
    for name in ("mamba2-1.3b", "olmoe-1b-7b", "zamba2-7b",
                 "seamless-m4t-medium", "qwen2-0.5b"):
        names = {p.rsplit("/", 1)[-1]: p
                 for p, _ in flatten(param_template(get_arch(name)))}
        for leaf, path in names.items():
            small = leaf in ("ln", "ln1", "ln2", "ln3", "final_norm",
                             "enc_norm", "q_norm", "k_norm", "norm",
                             "conv_w", "conv_b", "A_log", "D", "dt_bias",
                             "bq", "bk", "bv")
            assert matrix_gathers({path: 2}) == (0 if small else 2), path
    for leaf in ("in_proj", "out_proj", "router", "dec_embed"):
        assert leaf in MATRIX_LEAVES


def test_make_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = get_arch("mamba2-1.3b").reduced()
    shape = InputShape("t", 8, 1, "train")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        input_specs.make_batch(cfg, shape)
    assert input_specs.make_batch(cfg, shape, device="cpu")[
        "tokens"].device.type == "cpu"


def test_dry_run_gathers_no_matrix_leaf_of_any_arch():
    """Every arch at train_4k on the 16x16 mesh: the leaves gathered
    whole are small ones (none at these specs, but zamba2's conv taps),
    and the model axis's collectives are counted."""
    mesh = make_production_mesh()
    shape = get_shape("train_4k")
    for arch in sorted(ARCHS):
        res = dryrun.train_zampling(get_arch(arch), shape, mesh)
        coll = res["collective_bytes_per_rank"]
        assert matrix_gathers({p: 1 for p in
                               coll["model_gathered_leaves"]}) == 0, arch
        assert coll["model_gathered_leaves"] == (
            ["mamba/ssm/conv_w"] if arch == "zamba2-7b" else []), arch
        per = coll["model_axis_per_step"]
        assert per and all(e["count"] > 0 and e["bytes"] > 0
                           for e in per.values()), arch
