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
   axis's collectives a local step, the dense leaves' f32 mean, and in
   mode ``baseline`` dense data-parallel training's f32 gradient
   all-reduce of each rank's parameter shard.  On the model axis the
   dense decoder's partitioned consumers (``models.common``) make, a
   layer, the row-parallel products' forward all-reduces and the
   column-parallel inputs' backward all-reduces (or, where a block
   splits a head, the gathers of q/k/v and of ``wo``'s input
   cotangent), the embedding's all-reduce, ``lm_head``'s input
   cotangent and the vocab-parallel CE's three f32 all-reduces
   (``model_axis_per_step``: count and bytes a rank hands each, an
   all-reduce's operand, an all-gather's own block); the leaves they
   do not take as blocks (norm scales), and every sharded leaf of the
   other families, are gathered whole (``model_gather_per_step``: the
   whole leaves' bytes, read from the constraints);
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
from ..models.common import CE_CHUNK
from ..models.model import (_BLOCK_LEAVES, _dense_decoder, build_model,
                            param_template)
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
    placed = {p: shp.model_axis_of(constraints[p]) for p in zspecs.specs}
    consumers = (_consumer_collectives(cfg, shape, mesh, zspecs, placed)
                 if _dense_decoder(cfg) and ms > 1 else {})
    gathers = {p: _nbytes(spec.shape, zspecs.template[p].torch_dtype)
               for p, spec in zspecs.specs.items()
               if placed[p] is not None
               and not (consumers and p.rsplit("/", 1)[-1] in _BLOCK_LEAVES)}
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
            "model_gathered_leaves": sorted(gathers),
            "model_axis_per_step": consumers,
            "dense_mean": {"all-reduce": f32_dense},
        },
        "sharded_leaves": len(gathers),
        "zampling": {"m_total": zspecs.m_total, "n_total": zspecs.n_total,
                     "compression": zspecs.compression,
                     "comm_bits": zspecs.comm_bits_per_round()},
    }


def _tally(out: dict, name: str, nbytes: int, count: int = 1) -> None:
    entry = out.setdefault(name, {"count": 0, "bytes": 0})
    entry["count"] += count
    entry["bytes"] += nbytes


def _consumer_collectives(cfg: ArchConfig, shape: InputShape, mesh: Mesh,
                          zspecs: ZamplingSpecs, placed) -> Dict[str, Any]:
    """The dense decoder's model-axis collectives a local step, a rank:
    {name: {"count", "bytes"}}, as ``models.common``, ``models.attention``
    and ``models.model`` make them for one client at this shape's
    per-rank batch, the blocks those ``placed`` ({path: split dim or
    None}) names on the zampled sharded leaves."""
    ms = mesh.axis_size("model")
    dn = data_size(mesh)
    b = shape.global_batch
    b = b // dn if b % dn == 0 and b >= dn else b
    tok = b * shape.seq_len
    act = torch.empty((), dtype=_dtype(cfg.dtype)).element_size()
    tmpl = zspecs.template
    D, L = cfg.d_model, cfg.n_layers

    def kind(path):
        """'c' (column block), 'r' (row block) or None (whole)."""
        spec = zspecs.specs.get(path)
        if spec is None or spec.shard_count == 1 or placed[path] is None:
            return None
        nd = len(tmpl[path].shape)
        return {nd - 1: "c", nd - 2: "r"}.get(placed[path])

    out: Dict[str, Any] = {}

    def project(path, d_in, d_out, shared_input=False):
        """``models.common.project``'s collectives, ``L`` layers."""
        k = kind(path)
        if k == "c":
            _tally(out, "activation_gather", L * tok * d_out // ms * act, L)
            if not shared_input:
                _tally(out, "column_parallel_backward", L * tok * d_in * act,
                       L)
        elif k == "r":
            _tally(out, "row_parallel_forward", L * tok * d_out * act, L)
            _tally(out, "activation_gather", L * tok * d_in // ms * act, L)

    def column_input(paths, d_in):
        if any(kind(p) == "c" for p in paths):
            _tally(out, "column_parallel_backward", L * tok * d_in * act, L)

    hd = cfg.resolved_head_dim
    h, kv = cfg.n_heads * hd, cfg.n_kv * hd
    attn = [f"blocks/attn/{w}" for w in ("wq", "wk", "wv", "wo")]
    column_input(attn[:3], D)
    if ([kind(p) for p in attn] == ["c", "c", "c", "r"]
            and cfg.n_kv % ms == 0):
        _tally(out, "row_parallel_forward", L * tok * D * act, L)
    else:
        for p, d_out in zip(attn[:3], (h, kv, kv)):
            project(p, D, d_out, shared_input=True)
        project(attn[3], h, D)
    mlp = [f"blocks/mlp/{w}" for w in ("gate", "up", "down")]
    column_input(mlp[:2], D)
    if [kind(p) for p in mlp] == ["c", "c", "r"]:
        _tally(out, "row_parallel_forward", L * tok * D * act, L)
    else:
        for p in mlp[:2]:
            project(p, D, cfg.d_ff, shared_input=True)
        project(mlp[2], cfg.d_ff, D)
    if not cfg.embed_stub:
        if kind("embed") == "r":
            _tally(out, "embedding", tok * D * act)
        elif kind("embed") == "c":
            _tally(out, "embedding", tok * D // ms * act)
    V = cfg.padded_vocab
    if kind("lm_head") == "c":
        _tally(out, "column_parallel_backward", tok * D * act)
        t = b * (shape.seq_len - 1)  # CE tokens a client, chunk-padded
        t = -(-t // CE_CHUNK) * CE_CHUNK if t > CE_CHUNK else t
        _tally(out, "cross_entropy", 3 * 4 * t, 3)
    elif kind("lm_head") == "r":
        _tally(out, "row_parallel_forward", tok * V * act)
        _tally(out, "activation_gather", tok * D // ms * act)
    for p, spec in zspecs.specs.items():  # the leaves gathered whole
        if (spec.shard_count > 1 and placed[p] is not None
                and p.rsplit("/", 1)[-1] not in _BLOCK_LEAVES):
            _tally(out, "small_leaf_gather",
                   _nbytes(tmpl[p].shape, tmpl[p].torch_dtype) // ms)
    return out


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
