"""The port's meshes, sharding rules, sharded spec sets and dry run
against the JAX package's; nothing spawns and nothing runs on a device.

The rules (``launch/sharding.py``) read only a mesh's axis names and
shape, so JAX's run here on stub meshes of 16x16, 2x16x16, (2, 2) and
(1, 4): ``param_spec`` on every leaf of the ten archs' full-size
templates, ``batch_spec`` on every input of every shape, ``cache_spec``
on every leaf of every decode cache (its shapes from a ``meta`` device).
``build_specs(shard_plan_fn=)`` with the JAX dry run's plan and config
against JAX's, field by field; ``state_spec``; ``convert.zspecs_from_jax``
on sharded JAX specs; a state's slices to each model rank and back; the
two re-export shims; and the port's dry run over every (arch, shape) on
both production meshes, its ``zampling`` meta and skip list against what
JAX's ``build_specs`` and ``supports_shape`` give.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import zampling as jz
from repro.launch import mesh as jmesh, sharding as jshp
from repro_torch import convert
from repro_torch.comm import bitpack as tbp
from repro_torch.comm.downlink import get_codec
from repro_torch.comm.shardmap import AxisGroup
from repro_torch.configs.registry import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.core import reconstruct as trec, zampling as tz
from repro_torch.launch import dryrun, mesh as tmesh, sharding as tshp
from repro_torch.launch.input_specs import input_specs
from repro_torch.models.model import build_model, param_template

MESHES = [(("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)),
          (("data", "model"), (2, 2)), (("data", "model"), (1, 4))]


class _StubMesh:
    """What JAX's sharding rules read of a mesh."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


def _jtemplate(template):
    """A JAX template of ShapeDtypeStructs from the port's nested one."""
    def one(node):
        if isinstance(node, dict):
            return {k: one(v) for k, v in node.items()}
        return jax.ShapeDtypeStruct(node.shape, jnp.dtype(node.dtype))

    return one(template)


def _cache_leaves(cfg, shape):
    model = build_model(cfg)
    cache = model.init_cache({}, shape.global_batch, shape.seq_len,
                             device="meta")
    return list(dryrun._cache_leaves(cache))


@pytest.mark.parametrize("names,shape", MESHES)
def test_rules_are_jaxs_on_every_leaf_of_every_arch(names, shape):
    jm, tm = _StubMesh(names, shape), tmesh.Mesh(names, shape)
    checked = 0
    for arch in sorted(ARCHS):
        cfg = get_arch(arch)
        for path, leaf in tz.flatten(param_template(cfg)):
            assert tshp.param_spec(path, leaf.shape, tm) == tuple(
                jshp.param_spec(path, leaf.shape, jm)), (arch, path)
            checked += 1
        for sname in SHAPES:
            s = get_shape(sname)
            for name, spec in input_specs(cfg, s).items():
                assert tshp.batch_spec(name, spec.shape, tm) == tuple(
                    jshp.batch_spec(name, spec.shape, jm)), (arch, name)
            if s.kind == "decode" and cfg.supports_shape(sname)[0]:
                for path, t in _cache_leaves(cfg, s):
                    assert tshp.cache_spec(path, tuple(t.shape), tm) == \
                        tuple(jshp.cache_spec(path, tuple(t.shape), jm))
    assert checked > 100
    jspecs = jshp.shard_map_specs({"a": jnp.zeros((8, 3)), "b": jnp.zeros(())},
                                  ("data",), True)
    assert tshp.shard_map_specs({"a": (8, 3), "b": ()}, ("data",), True) == {
        p: tuple(v) for p, v in jspecs.items()}


def test_meshes_are_jaxs():
    for multi in (False, True):
        tm = tmesh.make_production_mesh(multi_pod=multi)
        names, shape = (("pod", "data", "model"), (2, 16, 16)) if multi \
            else (("data", "model"), (16, 16))
        assert (tm.axis_names, tm.shape) == (names, shape)
        assert tmesh.data_axes(tm) == jmesh.data_axes(_StubMesh(names, shape))
        assert tmesh.data_size(tm) == (32 if multi else 16)
    host = tmesh.make_host_mesh()
    assert (host.axis_names, host.shape) == (("data", "model"), (1, 1))
    with pytest.raises(ValueError, match="do not match"):
        tmesh.Mesh(("data",), (2, 2))


def _jax_plan(mesh):
    def plan(path, shape):
        for i, axis in enumerate(jshp.param_spec(path, shape, mesh)):
            if axis == "model" or (isinstance(axis, tuple)
                                   and "model" in axis):
                return i
        return None

    return plan


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_sharded_specs_are_jaxs_and_convert_carries_them(arch):
    """The dry run's spec set (JAX ``dryrun.py``'s config and plan) field
    by field, ``state_spec``, the carry of JAX's specs, and the dry
    run's constraints accepted by ``check_constraints``."""
    cfg = get_arch(arch)
    tm = tmesh.make_production_mesh()
    jm = _StubMesh(tm.axis_names, tm.shape)
    jcfg = jz.ZamplingConfig(compression=32.0, d=8, window=512, seed=0,
                             min_size=1_000_000, shard_align=16)
    template = param_template(cfg)
    jzs = jz.build_specs(_jtemplate(template), jcfg,
                         shard_plan_fn=_jax_plan(jm))
    tzs = dryrun.zampling_specs(cfg, tm)
    assert dataclasses.asdict(tzs.config) == dataclasses.asdict(jcfg)
    assert list(tzs.specs) == list(jzs.specs)
    assert tzs.dense_paths == jzs.dense_paths
    for p, spec in tzs.specs.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jzs.specs[p])
    assert any(s.shard_count == 16 for s in tzs.specs.values())
    carried = convert.zspecs_from_jax(jzs)
    assert carried.specs == tzs.specs
    jstate, tstate = jz.state_spec(jzs), tz.state_spec(tzs)
    for part in ("scores", "dense"):
        assert list(tstate[part]) == list(jstate[part])
        for p, leaf in tstate[part].items():
            assert leaf.shape == jstate[part][p].shape
            assert jnp.dtype(leaf.dtype) == jstate[part][p].dtype
    tz.check_constraints(tzs, {p: tshp.param_spec(p, s.shape, tm)
                               for p, s in tzs.specs.items()})


def test_constraints_name_the_model_axis_on_the_major_axis_only():
    zs = tz.build_specs({"w": (64, 48), "v": (40, 24)},
                        tz.ZamplingConfig(compression=4, window=32,
                                          min_size=512, shard_align=4),
                        shard_plan_fn=lambda p, s: 1 if p == "w" else None)
    assert zs.specs["w"].shard_count == 4 and zs.specs["v"].shard_count == 1
    tz.check_constraints(zs, {"w": (None, "model"), "v": ()})
    for bad in ({"w": ("model", None)}, {"v": ("model", None)},
                {"w": ("data", None)}, {"x": ()}):
        with pytest.raises(ValueError):
            tz.check_constraints(zs, bad)


@pytest.mark.parametrize("codec", ["f32", "u8", "packed4"])
def test_a_states_slices_to_each_model_rank_and_back(codec):
    zs = tz.build_specs({"w": (64, 48), "v": (40, 24), "b": (48,)},
                        tz.ZamplingConfig(compression=3, window=32,
                                          min_size=512, shard_align=4),
                        shard_plan_fn=lambda p, s: 1 if p == "w" else None)
    rng = np.random.RandomState(1)
    c = get_codec(codec)
    scores = {p: torch.from_numpy(rng.rand(s.n).astype(np.float32))
              for p, s in zs.specs.items()}
    if c.quantized:
        scores = {p: c.encode(zs.specs[p], v, 3) for p, v in scores.items()}
    state = {"scores": scores, "dense": {"b": torch.zeros(48)}}
    parts = [convert.to_model_rank(zs, state, s, 4) for s in range(4)]
    w = zs.specs["w"]
    per = scores["w"].shape[-1] // 4
    for s, st in enumerate(parts):
        assert torch.equal(st["scores"]["w"],
                           scores["w"][s * per:(s + 1) * per])
        assert st["scores"]["v"] is scores["v"]
        n = tz.shard_slice(w, AxisGroup(None, 4, s))[1]
        assert st["scores"]["w"].shape[-1] == c.wire_len(n)
    back = convert.from_model_ranks(zs, parts)
    for p in zs.specs:
        assert torch.equal(back["scores"][p], scores[p])
    np_back = convert.from_model_ranks(zs, [
        {"scores": {p: v.numpy() for p, v in st["scores"].items()}}
        for st in parts])
    np.testing.assert_array_equal(np_back["scores"]["w"], scores["w"].numpy())


def test_the_shims_are_their_targets():
    from repro_torch.core import bitpack as core_bitpack
    from repro_torch.kernels import ref

    for name in ("pack_mask", "packed_len", "packed_popcount_sum",
                 "unpack_mask"):
        assert getattr(core_bitpack, name) is getattr(tbp, name)
    for name in ("reconstruct_ref", "materialize_q", "grad_z_ref"):
        assert getattr(ref, name) is getattr(trec, name)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_dry_run_of_every_arch_and_shape(multi_pod, tmp_path):
    """Every (arch, shape) on the production mesh: the skips and the SWA
    note JAX's rules give, JAX's zampling meta, and what each rank holds
    and sends, counted from the specs; the CLI writes a file each and
    exits 0."""
    tm = tmesh.make_production_mesh(multi_pod=multi_pod)
    jm = _StubMesh(tm.axis_names, tm.shape)
    jcfg = jz.ZamplingConfig(compression=32.0, d=8, window=512, seed=0,
                             min_size=1_000_000, shard_align=16)
    dn = 32 if multi_pod else 16
    for arch in sorted(ARCHS):
        jc = jreg.get_arch(arch)
        for sname in SHAPES:
            res = dryrun.dryrun_one(arch, sname, multi_pod=multi_pod)
            ok, note = jc.supports_shape(sname)
            assert res["skipped"] is (not ok)
            if not ok:
                assert res["reason"] == note
                continue
            if sname == "long_500k" and jc.family in ("dense", "moe",
                                                      "hybrid") \
                    and jc.window is None:
                assert res["note"] == "SWA variant W=4096"
            if get_shape(sname).kind != "train":
                assert res["rank_bytes"]["params"] > 0
                if get_shape(sname).kind == "decode":
                    assert res["rank_bytes"]["cache"] > 0
                continue
            jzs = jz.build_specs(_jtemplate(param_template(get_arch(arch))),
                                 jcfg, shard_plan_fn=_jax_plan(jm))
            meta = res["zampling"]
            assert meta == {"m_total": jzs.m_total, "n_total": jzs.n_total,
                            "compression": jzs.compression,
                            "comm_bits": jzs.comm_bits_per_round()}
            coll = res["collective_bytes_per_rank"]
            n_rank = sum(s.n // (16 if s.shard_count > 1 else 1)
                         for s in jzs.specs.values())
            assert res["rank_bytes"]["scores"] == 4 * n_rank
            assert coll["uplink"]["mean_f32"] == {"all-reduce": 4 * n_rank}
            assert coll["uplink"]["allgather_packed"]["all-gather"] == \
                dn * coll["uplink"]["psum_u32"]["all-reduce"]
            leaves = dict(jz._flatten(jzs.template))
            assert coll["model_gather"] == sum(
                int(np.prod(s.shape)) * leaves[p].dtype.itemsize
                for p, s in jzs.specs.items() if s.shard_count > 1)
    baseline = dryrun.dryrun_one("qwen2-0.5b", "train_4k",
                                 multi_pod=multi_pod, mode="baseline")
    assert baseline["collective_bytes_per_rank"]["grad_all_reduce"][
        "all-reduce"] > 0
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k",
                     "--out", str(tmp_path)] + (["--multi-pod"]
                                                if multi_pod else []))
    assert e.value.code == 0
    assert len(list(tmp_path.glob("*.json"))) == 1
