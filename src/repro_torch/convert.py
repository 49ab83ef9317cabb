"""Carry the JAX package's serving, federated and local states across
to the port.

The JAX package's ``ServeState`` holds ``words`` and ``dense`` dicts
keyed by path strings and a uint32 draw word ``step``; as numpy arrays
they become the port's ``ServeState`` under the same paths, its codec
the tag that checks them (a packed codec's uint32 lanes cross as
``torch.uint32``, which no dtype alone could name).  A
federated round state ``{"scores": {path: f32 scores, u8/u16 wire
words or a packed codec's uint32 lanes}, "dense": {path: leaf}}``
becomes the same dict of tensors (lanes as ``torch.uint32``), and
so does a local-training state, whose Adam state (``step``, ``mu``,
``nu`` over the same tree) becomes the port's ``AdamState`` over the
flat {path: leaf} dict the port's optimizers see.  bf16
leaves (``ml_dtypes`` arrays) widen to float32 on the way and land in
their template's dtype: the LM round state of the JAX package's
``launch/train.py`` (f32 scores, bf16 dense leaves at full width) comes
across exactly, for every model family (the MoE router and the SSM's
``A_log``, ``D`` and ``dt_bias`` stay float32, as their templates say;
dense leaves are keyed by their nested paths, ``blocks/ssm/A_log``).  The port's spec set is
rebuilt from the JAX template's shapes and config, each leaf's
``major_axis``/``shard_count`` taken from the JAX spec (a spec set built
with a ``shard_plan_fn``), and every QSpec is checked field by field
against the JAX one, so a mismatch in leaf order (and so in tensor ids)
raises here rather than serving other weights.

On a model axis a rank holds its slice of each sharded leaf's scores
(``kernels.qz_sharded``): ``to_model_rank`` cuts a whole round state to
rank ``sid``'s, ``from_model_ranks`` joins the ranks' states back.

Duck-typed: this module imports neither jax nor the JAX package; it
reads attributes and converts with ``numpy.asarray``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.zampling import (ZamplingConfig, ZamplingSpecs, build_specs,
                            state_to)
from .device import as_tensor, resolve_device
from .optim import AdamState
from .serve.state import ServeState, make_serve_state


def zspecs_from_jax(jzspecs) -> ZamplingSpecs:
    """The port's ZamplingSpecs for a JAX ``ZamplingSpecs``, sharded
    leaves included."""
    cfg = ZamplingConfig(**dataclasses.asdict(jzspecs.config))
    def plan(path, shape):
        # JAX's spec names the axis where its plan sharded the leaf
        del shape
        spec = jzspecs.specs.get(path)
        if spec is None or spec.shard_count == 1:
            return None
        return spec.major_axis

    zspecs = build_specs(jzspecs.template, cfg, shard_plan_fn=plan)
    if set(zspecs.specs) != set(jzspecs.specs):
        raise ValueError("zampled leaves differ: port "
                         f"{sorted(zspecs.specs)}, JAX {sorted(jzspecs.specs)}")
    for path, spec in zspecs.specs.items():
        theirs = dataclasses.asdict(jzspecs.specs[path])
        if dataclasses.asdict(spec) != theirs:
            raise ValueError(f"QSpec of {path!r} differs: port "
                             f"{dataclasses.asdict(spec)}, JAX {theirs}")
    return zspecs


def _slice_of(zspecs: ZamplingSpecs, path: str, leaf, sid: int, ms: int):
    """Rank ``sid``'s slice of a score leaf (f32 scores, u8/u16 words or
    packed lanes; the whole leaf for one a model axis replicates)."""
    from .kernels.qz_sharded import shard_coords

    spec = zspecs.specs[path]
    if spec.shard_count == 1:
        return leaf
    c0, n = shard_coords(spec, sid, ms)
    per = spec.n // leaf.shape[-1]  # coordinates a lane (1: a word each)
    if per > 1 and (c0 % per or n % per):
        raise ValueError(f"{path!r}: shard {sid}'s coordinates [{c0}, "
                         f"{c0 + n}) hold no whole lanes of {per}")
    return leaf[..., c0 // per:(c0 + n) // per]


def to_model_rank(zspecs: ZamplingSpecs, state, sid: int, ms: int):
    """Rank ``sid`` of a model axis of ``ms``: the round state with each
    sharded leaf's scores cut to its slice; dense leaves (and any other
    key) as they are."""
    return {**state, "scores": {p: _slice_of(zspecs, p, v, sid, ms)
                                for p, v in state["scores"].items()}}


def from_model_ranks(zspecs: ZamplingSpecs, states):
    """The whole round state from the model ranks' states, rank 0 first:
    each sharded leaf's slices joined, the rest taken from rank 0."""
    def join(path):
        parts = [st["scores"][path] for st in states]
        if zspecs.specs[path].shard_count == 1:
            return parts[0]
        if isinstance(parts[0], torch.Tensor):
            return torch.cat(parts, -1)
        return np.concatenate(parts, -1)

    return {**states[0], "scores": {p: join(p) for p in zspecs.specs}}


def serve_state_from_arrays(zspecs: ZamplingSpecs, codec: str, words, dense,
                            step, *, device="cuda") -> ServeState:
    """A port ServeState from numpy ``words``/``dense`` dicts and a draw
    word, keyed by the JAX package's path strings."""
    state = {"scores": {p: np.asarray(words[p]) for p in zspecs.specs},
             "dense": {p: np.asarray(dense[p]) for p in zspecs.dense_paths}}
    return make_serve_state(zspecs, state, int(np.asarray(step)),
                            carried=codec, device=device)


def serve_state_from_jax(jstate, *, device="cuda") -> ServeState:
    """The port's ServeState for a JAX ``ServeState``."""
    zspecs = zspecs_from_jax(jstate.zspecs)
    return serve_state_from_arrays(zspecs, jstate.codec, jstate.words,
                                   jstate.dense, jstate.step, device=device)


def federated_state_from_arrays(zspecs: ZamplingSpecs, scores, dense, *,
                                downlink_b=None, device="cuda"):
    """The port's round state from numpy ``scores`` (f32 scores, the
    codec's u8/u16 words or uint32 lanes, as ``encode_state`` carries
    them) and
    ``dense`` dicts keyed by the JAX package's path strings; each dense
    leaf in its template's dtype (bf16 leaves of an LM through f32).
    ``downlink_b``: a frontier schedule's per-tensor widths, carried as
    int64."""
    state = {"scores": {p: np.asarray(scores[p]) for p in zspecs.specs},
             "dense": {p: np.asarray(dense[p]) for p in zspecs.dense_paths}}
    if downlink_b is not None:
        state["downlink_b"] = np.asarray(downlink_b)
    return state_to(zspecs, state, resolve_device(device))


def federated_state_from_jax(jzspecs, jstate, *, device="cuda"):
    """(the port's ZamplingSpecs, its round state) for a JAX
    ``ZamplingSpecs`` and a JAX federated state (``encode_state``'s
    output with a frontier schedule's ``downlink_b``, or an f32
    ``init_state``)."""
    zspecs = zspecs_from_jax(jzspecs)
    return zspecs, federated_state_from_arrays(
        zspecs, jstate["scores"], jstate["dense"],
        downlink_b=jstate.get("downlink_b"), device=device)


def local_state_from_arrays(zspecs: ZamplingSpecs, scores, dense,
                            adam_state=None, *, device="cuda"):
    """(the port's local state, its ``AdamState`` or None) from numpy
    ``scores``/``dense`` dicts keyed by the JAX package's path strings
    and, optionally, an Adam state ``(step, mu, nu)`` whose ``mu``/``nu``
    are ``{"scores": {...}, "dense": {...}}`` dicts of the same leaves."""
    dev = resolve_device(device)
    state = federated_state_from_arrays(zspecs, scores, dense, device=dev)
    if adam_state is None:
        return state, None
    step, mu, nu = adam_state

    def flat(tree):
        return {p: as_tensor(np.asarray(tree[part][p]), dev, torch.float32)
                for part, paths in (("scores", zspecs.specs),
                                    ("dense", zspecs.dense_paths))
                for p in paths}

    return state, AdamState(
        torch.as_tensor(int(np.asarray(step)), dtype=torch.int32,
                        device=dev), flat(mu), flat(nu))


def local_state_from_jax(jzspecs, jstate, jadam_state=None, *,
                         device="cuda"):
    """(the port's ZamplingSpecs, local state, AdamState or None) for a
    JAX ``ZamplingSpecs``, a JAX local state (``init_state`` or
    ``train_local_zampling``'s) and, optionally, its ``AdamState``."""
    zspecs = zspecs_from_jax(jzspecs)
    state, opt = local_state_from_arrays(zspecs, jstate["scores"],
                                         jstate["dense"], jadam_state,
                                         device=device)
    return zspecs, state, opt
