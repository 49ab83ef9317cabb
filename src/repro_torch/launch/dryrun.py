"""The production mesh's dry run: what each rank holds and sends.

The JAX package's ``launch/dryrun.py`` lowers and compiles every (arch,
input shape) on 512 placeholder devices and reads XLA's memory, cost
and collective analyses.  The port has no HLO to lower, so its dry run
records what the port knows without running anything or allocating on
a device, per (arch, shape, mesh, mode):

 - each rank's bytes: the zampled leaves' scores (a model rank's slice
   of a sharded leaf, the whole vector of one the model axis
   replicates), the dense leaves (replicated over the model axis), its
   shard of the batch (``batch_spec``) and, for a decode shape, of the
   KV/SSM cache (``cache_spec``, the cache's shapes from a ``meta``
   device); prefill and decode hold the parameters by ``param_spec``;
 - the collectives a round issues, by kind and bytes a rank: the
   uplink's over the data axes under each transport (``psum_u32``: an
   all-reduce of its lanes' counts; ``allgather_packed``: an all-gather
   of the lanes; ``mean_f32``: an all-reduce of f32 masks), the model
   axis's all-gathers of each sharded leaf a local step
   (``comm.shardmap.gather_major``: the whole leaf in its dtype, read
   from the constraints), the dense leaves' f32 mean, and in mode
   ``baseline`` dense data-parallel training's f32 gradient all-reduce
   of each rank's parameter shard;
 - JAX's ``zampling`` meta (``m_total``, ``n_total``, ``compression``,
   ``comm_bits``), its skip rules (``ArchConfig.supports_shape``) and
   the ``long_500k`` sliding-window note.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--mode baseline]

One JSON file per combination goes to ``--out``; the exit code is 1 when
any combination failed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import traceback
from typing import Any, Dict

import torch

from ..comm.bitpack import packed_len
from ..configs.base import ArchConfig
from ..configs.registry import ARCHS, SHAPES, InputShape, get_arch, get_shape
from ..core.zampling import (ZamplingConfig, ZamplingSpecs, build_specs,
                             check_constraints, flatten, state_spec)
from ..models.model import build_model, param_template
from . import sharding as shp
from .input_specs import input_specs
from .mesh import Mesh, data_axes, data_size, make_production_mesh

TRANSPORTS = ("psum_u32", "allgather_packed", "mean_f32")


def zampling_config(cfg: ArchConfig) -> ZamplingConfig:
    """The JAX dry run's reparametrization for the big archs: m/n=32,
    d=8, the model axis's 16-way alignment."""
    del cfg
    return ZamplingConfig(compression=32.0, d=8, window=512, seed=0,
                          min_size=1_000_000, shard_align=16)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def shard_bytes(shape, dtype, placement, mesh: Mesh) -> int:
    """A rank's bytes of a leaf placed by ``placement`` on ``mesh``."""
    n = _nbytes(shape, _dtype(dtype))
    for entry in placement:
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            n //= mesh.axis_size(axis)
    return n


def _sharded_plan(mesh: Mesh):
    def plan(path, shape):
        return shp.model_axis_of(shp.param_spec(path, shape, mesh))

    return plan


def zampling_specs(cfg: ArchConfig, mesh: Mesh) -> ZamplingSpecs:
    """The dry run's spec set: ``param_spec`` names each leaf's major
    axis."""
    return build_specs(param_template(cfg), zampling_config(cfg),
                       shard_plan_fn=_sharded_plan(mesh))


def _batch(cfg: ArchConfig, shape: InputShape, mesh: Mesh) -> int:
    return sum(shard_bytes(s.shape, s.dtype, shp.batch_spec(p, s.shape, mesh),
                           mesh)
               for p, s in input_specs(cfg, shape).items())


def train_zampling(cfg: ArchConfig, shape: InputShape, mesh: Mesh,
                   local_steps: int = 1) -> Dict[str, Any]:
    """One federated zampling round: a client per data index, its
    sharded leaves split over the model axis."""
    zspecs = zampling_specs(cfg, mesh)
    constraints = {p: shp.param_spec(p, s.shape, mesh)
                   for p, s in zspecs.specs.items()}
    check_constraints(zspecs, constraints)
    ms, dn = mesh.axis_size("model"), data_size(mesh)
    tstate = state_spec(zspecs)
    n_rank = {p: (s.n // ms if s.shard_count > 1 else s.n)
              for p, s in zspecs.specs.items()}
    lanes = sum(packed_len(n) for n in n_rank.values())
    dense = sum(_nbytes(leaf.shape, leaf.torch_dtype)
                for leaf in tstate["dense"].values())
    gathers = {p: _nbytes(spec.shape, zspecs.template[p].torch_dtype)
               for p, spec in zspecs.specs.items()
               if shp.model_axis_of(constraints[p]) is not None}
    uplink = {"psum_u32": {"all-reduce": 4 * lanes},
              "allgather_packed": {"all-gather": 4 * lanes * dn},
              "mean_f32": {"all-reduce": 4 * sum(n_rank.values())}}
    f32_dense = 4 * sum(math.prod(leaf.shape)
                        for leaf in tstate["dense"].values())
    return {
        "rank_bytes": {"scores": 4 * sum(n_rank.values()),
                       "dense": dense,
                       "batch": _batch(cfg, shape, mesh)},
        "collective_bytes_per_rank": {
            "uplink": uplink,
            "model_gather_per_step": sum(gathers.values()),
            "model_gather": local_steps * sum(gathers.values()),
            "dense_mean": {"all-reduce": f32_dense},
        },
        "sharded_leaves": len(gathers),
        "zampling": {"m_total": zspecs.m_total, "n_total": zspecs.n_total,
                     "compression": zspecs.compression,
                     "comm_bits": zspecs.comm_bits_per_round()},
    }


def _param_bytes(cfg: ArchConfig, mesh: Mesh) -> int:
    return sum(shard_bytes(leaf.shape, leaf.dtype,
                           shp.param_spec(p, leaf.shape, mesh), mesh)
               for p, leaf in flatten(param_template(cfg)))


def train_baseline(cfg: ArchConfig, shape: InputShape,
                   mesh: Mesh) -> Dict[str, Any]:
    """Dense data-parallel training: each rank's parameter shard, and its
    f32 gradient all-reduce over the data axes."""
    grads = sum(shard_bytes(leaf.shape, torch.float32,
                            shp.param_spec(p, leaf.shape, mesh), mesh)
                for p, leaf in flatten(param_template(cfg)))
    return {"rank_bytes": {"params": _param_bytes(cfg, mesh),
                           "batch": _batch(cfg, shape, mesh)},
            "collective_bytes_per_rank": {"grad_all_reduce": {
                "all-reduce": grads}}}


def _cache_leaves(cache, prefix="cache"):
    if isinstance(cache, torch.Tensor):
        yield prefix, cache
        return
    for name in cache._fields:
        yield from _cache_leaves(getattr(cache, name), f"{prefix}/{name}")


def serve(cfg: ArchConfig, shape: InputShape, mesh: Mesh,
          window_override=None) -> Dict[str, Any]:
    """Prefill (the prompt's batch) or one decode step against a cache of
    ``seq_len`` (built on the ``meta`` device: shapes only)."""
    out = {"rank_bytes": {"params": _param_bytes(cfg, mesh),
                          "batch": _batch(cfg, shape, mesh)}}
    if shape.kind == "decode":
        model = build_model(cfg, window_override=window_override)
        cache = model.init_cache({}, shape.global_batch, shape.seq_len,
                                 device="meta")
        out["rank_bytes"]["cache"] = sum(
            shard_bytes(t.shape, t.dtype,
                        shp.cache_spec(p, tuple(t.shape), mesh), mesh)
            for p, t in _cache_leaves(cache))
    return out


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               mode: str = "zampling", window_override=None,
               local_steps: int = 1) -> Dict[str, Any]:
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    ok, note = cfg.supports_shape(shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": note}
    if (shape_name == "long_500k" and cfg.family in ("dense", "moe", "hybrid")
            and cfg.window is None and window_override is None):
        # the documented SWA long-context variant; for the hybrid the SSM
        # backbone carries the long-range state
        window_override = 4096
        note = "SWA variant W=4096"
    mesh = make_production_mesh(multi_pod=multi_pod)
    if shape.kind == "train":
        res = (train_zampling(cfg, shape, mesh, local_steps)
               if mode == "zampling" else train_baseline(cfg, shape, mesh))
    else:
        res = serve(cfg, shape, mesh, window_override)
    return {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "data_axes": list(data_axes(mesh)), "mode": mode, "note": note,
            "skipped": False, **res}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="zampling",
                    choices=["zampling", "baseline"])
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    if args.all:
        jobs = [(a, s) for a in sorted(ARCHS) for s in SHAPES]
    else:
        jobs = [(args.arch, args.shape)]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in jobs:
        tag = (f"{arch}_{shape}_{'2x16x16' if args.multi_pod else '16x16'}"
               f"_{args.mode}")
        try:
            res = dryrun_one(arch, shape, multi_pod=args.multi_pod,
                             mode=args.mode, local_steps=args.local_steps)
        except Exception as e:  # noqa: BLE001 — record and go on
            failures += 1
            res = {"arch": arch, "shape": shape, "error": str(e),
                   "traceback": traceback.format_exc()}
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(res, f, indent=2)
        status = ("SKIP " + res.get("reason", "") if res.get("skipped")
                  else "FAIL " + res.get("error", "")[:80] if "error" in res
                  else f"ok rank_bytes={res['rank_bytes']}")
        print(f"[dryrun] {tag}: {status}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
