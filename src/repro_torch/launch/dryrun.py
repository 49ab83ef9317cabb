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
   all-reduce of each rank's parameter shard.  On the model axis every
   family's partitioned consumers (``models.common``, ``attention``,
   ``moe``, ``ssm``, ``model``) make, for one client at the shape's
   per-rank batch (``consumer_collectives``, ``model_axis_per_step``:
   count and bytes a rank hands each, an all-reduce's operand, an
   all-gather's own block), the row-parallel products' forward
   all-reduces and the column-parallel inputs' backward all-reduces (or,
   where a block splits a head, the gathers of q/k/v and of ``wo``'s
   input cotangent), the MoE's logits and combine, the SSM's gathered
   projections and split norm sums (its layers' forward collectives
   twice: the backward recomputes them), the replicated leaves and
   activations that meet rank-local work, the embedding's all-reduce,
   ``lm_head``'s input cotangent and the vocab-parallel CE's three f32
   all-reduces; the sharded leaves no consumer takes as a block (norm
   scales, the SSM's conv taps) are gathered whole
   (``model_gather_per_step``: the whole leaves' bytes, read from the
   constraints; ``model_gathered_leaves`` names them);
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
from ..models.model import (_BLOCK_LEAVES, attn_dims, build_model,
                            enc_attn_dims, family, param_template)
from ..models.moe import GROUP_SIZE
from ..models.ssm import in_proj_dim, ssm_dims
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
    consumers = (consumer_collectives(cfg, shape, mesh, zspecs, placed)
                 if ms > 1 else {})
    gathers = {p: _nbytes(spec.shape, zspecs.template[p].torch_dtype)
               for p, spec in zspecs.specs.items()
               if _whole(p, spec, placed)}
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


def _whole(path: str, spec, placed) -> bool:
    """A sharded leaf that no consumer takes as a block: gathered whole
    (``models.model._placed``)."""
    return (spec.shard_count > 1 and placed[path] is not None
            and path.rsplit("/", 1)[-1] not in _BLOCK_LEAVES)


# model_axis_per_step's entries by the kind ``comm.shardmap.COUNTS``
# counts them under
COUNTED_AS = {
    "row_parallel_forward": "all_reduce",  # partial products summed
    "column_parallel_backward": "all_reduce",  # an input's cotangent
    "replicated_cotangent": "all_reduce",  # a replicated value used by rank
    "norm_sum": "all_reduce",  # a split RMSNorm's sum, both ways
    "embedding": "all_reduce",
    "cross_entropy": "all_reduce",
    "activation_gather": "all_gather",  # blocks of an activation joined
    "embedding_gather": "all_gather",
    "bias_gather": "all_gather",  # replicated biases' cotangent blocks
    "small_leaf_gather": "leaf_gather",
}


def as_counts(per_step: Dict[str, Any]) -> Dict[str, int]:
    """``model_axis_per_step`` in ``comm.shardmap.COUNTS``'s form:
    {kind: calls, kind + "_bytes": bytes}."""
    out: Dict[str, int] = {}
    for name, entry in per_step.items():
        kind = COUNTED_AS[name]
        out[kind] = out.get(kind, 0) + entry["count"]
        out[kind + "_bytes"] = out.get(kind + "_bytes", 0) + entry["bytes"]
    return out


def _tally(out: dict, name: str, nbytes: int, count: int = 1) -> None:
    if not count:
        return
    entry = out.setdefault(name, {"count": 0, "bytes": 0})
    entry["count"] += count
    entry["bytes"] += nbytes


def consumer_collectives(cfg: ArchConfig, shape: InputShape, mesh: Mesh,
                         zspecs: ZamplingSpecs, placed) -> Dict[str, Any]:
    """The partitioned consumers' model-axis collectives a local step, a
    rank: {name: {"count", "bytes"}}, as ``models.common``,
    ``attention``, ``moe``, ``ssm`` and ``model`` make them for one
    client at this shape's per-rank batch, the blocks those ``placed``
    ({path: split dim or None}) names on the zampled sharded leaves."""
    ms = mesh.axis_size("model")
    dn = data_size(mesh)
    b = shape.global_batch
    b = b // dn if b % dn == 0 and b >= dn else b
    tok = b * shape.seq_len
    act = torch.empty((), dtype=_dtype(cfg.dtype)).element_size()
    tmpl = zspecs.template
    D, L = cfg.d_model, cfg.n_layers
    out: Dict[str, Any] = {}

    def kind(path):
        """'c' (column block), 'r' (row block), 'e' (an expert stack's E
        block) or None (whole: replicated or gathered)."""
        spec = zspecs.specs.get(path)
        if (spec is None or spec.shard_count == 1 or placed[path] is None
                or path.rsplit("/", 1)[-1] not in _BLOCK_LEAVES):
            return None
        nd = len(tmpl[path].shape)
        return {nd - 1: "c", nd - 2: "r", nd - 3: "e"}.get(placed[path])

    def nbytes(path, n=1):
        """``n`` elements of a leaf's dtype, in bytes."""
        return n * tmpl[path].torch_dtype.itemsize

    def project(path, t, d_in, d_out, n, shared_input=False, fwd=1):
        """``models.common.project``'s collectives, ``n`` uses of ``t``
        tokens, the forward ones ``fwd`` times each (2: recomputed)."""
        k = kind(path)
        if k == "c":
            _tally(out, "activation_gather", fwd * n * t * d_out // ms * act,
                   fwd * n)
            if not shared_input:
                _tally(out, "column_parallel_backward", n * t * d_in * act,
                       n)
        elif k == "r":
            _tally(out, "row_parallel_forward", fwd * n * t * d_out * act,
                   fwd * n)
            _tally(out, "activation_gather", n * t * d_in // ms * act, n)

    def column_input(paths, t, d_in, n):
        if any(kind(p) == "c" for p in paths):
            _tally(out, "column_parallel_backward", n * t * d_in * act, n)

    def attention(pre, dims, t, n, layers):
        """``self_attention`` (``n`` uses of ``t`` tokens; ``layers``
        stacked, 0 for the hybrid's shared block), and ``_placed``'s
        bias blocks and qk-norm copies, once a step."""
        hd = dims.head_dim
        q, kv = dims.n_heads * hd, dims.n_kv * hd
        w = [pre + x for x in ("wq", "wk", "wv", "wo")]
        column_input(w[:3], t, D, n)
        heads = ([kind(p) for p in w] == ["c", "c", "c", "r"]
                 and dims.n_kv % ms == 0)
        if heads:
            _tally(out, "row_parallel_forward", n * t * D * act, n)
        else:
            for p, d_out in zip(w[:3], (q, kv, kv)):
                project(p, t, D, d_out, n, shared_input=True)
            project(w[3], t, q, D, n)
        per = max(layers, 1)
        for bias, wt, d_out in (("bq", "wq", q), ("bk", "wk", kv),
                                ("bv", "wv", kv)):
            if pre + bias in tmpl and kind(pre + bias) is None \
                    and kind(pre + wt) == "c":
                _tally(out, "bias_gather", nbytes(pre + bias,
                                                  per * d_out // ms))
        for norm in ("q_norm", "k_norm"):
            if heads and pre + norm in tmpl:
                _tally(out, "replicated_cotangent",
                       nbytes(pre + norm, per * hd))

    def mlp(pre, t, d_ff, n):
        w = [pre + x for x in ("gate", "up", "down")]
        column_input(w[:2], t, D, n)
        if [kind(p) for p in w] == ["c", "c", "r"]:
            _tally(out, "row_parallel_forward", n * t * D * act, n)
        else:
            for p in w[:2]:
                project(p, t, D, d_ff, n, shared_input=True)
            project(w[2], t, d_ff, D, n)

    def moe(pre, t, n):
        """``models.moe.moe_block``: the router's logits, the experts on E
        or on F, the combine."""
        mc = cfg.moe
        E = mc.num_experts
        G = min(GROUP_SIZE, t)
        G = t if t % G else G
        C = max(1, int(mc.capacity_factor * G * mc.top_k / E))
        split = {("e", "e", "e"): "experts", ("c", "c", "r"): "ffn"}.get(
            tuple(kind(pre + x) for x in ("gate", "up", "down")))
        if split is not None:  # the input through copy_to_model
            _tally(out, "column_parallel_backward", n * t * D * act, n)
        router = kind(pre + "router")
        if router == "c":
            _tally(out, "activation_gather", n * t * E // ms * 4, n)
            if split is None:
                _tally(out, "column_parallel_backward", n * t * D * act, n)
        elif router == "r":
            _tally(out, "row_parallel_forward", n * t * E * 4, n)
            _tally(out, "activation_gather", n * t * D // ms * act, n)
        if split == "experts":  # the combine's slice joined
            _tally(out, "activation_gather", n * t * E // ms * C * act, n)
        elif split == "ffn":  # the combine's partial cotangents summed
            _tally(out, "replicated_cotangent", n * t * E * C * act, n)
        if split is not None:
            _tally(out, "row_parallel_forward", n * t * D * act, n)

    def ssm(pre, t, n):
        """``models.ssm.ssm_block`` on the rank's heads, its forward
        collectives twice (the layer is recomputed in the backward), and
        ``_placed``'s replicated leaves, once a step."""
        sd = ssm_dims(D, cfg.ssm)
        leaves = [pre + x for x in ("in_proj", "out_proj", "A_log", "D",
                                    "dt_bias", "norm")]
        if all(kind(p) is None for p in leaves):
            return
        di, H, n_in = sd.d_inner, sd.n_heads, in_proj_dim(sd)
        project(pre + "in_proj", t, D, n_in, n, fwd=2)
        _tally(out, "replicated_cotangent", n * t * n_in * act, n)  # zxbcdt
        cd = di + 2 * sd.n_groups * sd.d_state
        for p, width in ((pre + "conv_w", sd.conv_width),
                         (pre + "conv_b", 1)):
            _tally(out, "replicated_cotangent", nbytes(p, n * width * cd))
        for p, width in ((pre + "A_log", H), (pre + "D", H),
                         (pre + "dt_bias", H), (pre + "norm", di)):
            if kind(p) is None:  # this rank's block of a replicated leaf
                _tally(out, "bias_gather", nbytes(p, n * width // ms))
        _tally(out, "norm_sum", 3 * n * t * 4, 3 * n)
        _tally(out, "activation_gather", 2 * n * t * di // ms * act, 2 * n)
        project(pre + "out_proj", t, di, D, n, fwd=2)

    fam = family(cfg)
    dims = attn_dims(cfg)
    if fam == "decoder":
        attention("blocks/attn/", dims, tok, L, L)
        if cfg.moe is not None:
            moe("blocks/moe/", tok, L)
        else:
            mlp("blocks/mlp/", tok, cfg.d_ff, L)
    elif fam in ("ssm", "hybrid"):
        pre = "blocks/ssm/" if fam == "ssm" else "mamba/ssm/"
        ssm(pre, tok, L)
        if fam == "hybrid":
            uses = -(-L // cfg.attn_every)
            attention("shared_attn/attn/", dims, tok, uses, 0)
            mlp("shared_attn/mlp/", tok, cfg.d_ff, uses)
    else:
        te = b * (shape.seq_len // 4)  # the encoder's frames
        ec = cfg.encoder
        attention("enc_blocks/attn/", enc_attn_dims(cfg), te, ec.n_layers,
                  ec.n_layers)
        mlp("enc_blocks/mlp/", te, ec.d_ff, ec.n_layers)
        attention("dec_blocks/attn/", dims, tok, L, L)
        mlp("dec_blocks/mlp/", tok, cfg.d_ff, L)
        cross = [f"dec_blocks/cross/{w}" for w in ("wq", "wk", "wv", "wo")]
        hd = dims.head_dim
        q, kv = dims.n_heads * hd, dims.n_kv * hd
        if kind(cross[1]) == "c" or kind(cross[2]) == "c":  # enc_in
            _tally(out, "column_parallel_backward", te * D * act)
        if ([kind(p) for p in cross] == ["c", "c", "c", "r"]
                and dims.n_kv % ms == 0):
            _tally(out, "column_parallel_backward", L * tok * D * act, L)
            _tally(out, "row_parallel_forward", L * tok * D * act, L)
        else:
            project(cross[0], tok, D, q, L)
            for p in cross[1:3]:
                project(p, te, D, kv, L, shared_input=True)
            project(cross[3], tok, q, D, L)
    emb = "dec_embed" if fam == "encdec" else "embed"
    if fam == "encdec" or not cfg.embed_stub:  # the encoder's are stubs
        if kind(emb) == "r":
            _tally(out, "embedding", tok * D * act)
        elif kind(emb) == "c":
            _tally(out, "embedding_gather", tok * D // ms * act)
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
        if _whole(p, spec, placed):
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
