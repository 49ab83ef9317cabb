"""Carry the JAX package's serving, federated and local states across
to the port.

The JAX package's ``ServeState`` holds ``words`` and ``dense`` dicts
keyed by path strings and a uint32 draw word ``step``; as numpy arrays
they become the port's ``ServeState`` under the same paths.  A
federated round state ``{"scores": {path: f32 scores or u8/u16 wire
words}, "dense": {path: leaf}}`` becomes the same dict of tensors, and
so does a local-training state, whose Adam state (``step``, ``mu``,
``nu`` over the same tree) becomes the port's ``AdamState`` over the
flat {path: leaf} dict the port's optimizers see.  bf16
leaves (``ml_dtypes`` arrays) widen to float32 on the way and land in
their template's dtype: the LM round state of the JAX package's
``launch/train.py`` (f32 scores, bf16 dense leaves at full width) comes
across exactly.  The port's spec set is
rebuilt from the JAX template's shapes and config, and every QSpec is
checked field by field against the JAX one, so a mismatch in leaf order
(and so in tensor ids) raises here rather than serving other weights.

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
    """The port's ZamplingSpecs for a JAX ``ZamplingSpecs``."""
    cfg = ZamplingConfig(**dataclasses.asdict(jzspecs.config))
    zspecs = build_specs(jzspecs.template, cfg)
    if set(zspecs.specs) != set(jzspecs.specs):
        raise ValueError("zampled leaves differ: port "
                         f"{sorted(zspecs.specs)}, JAX {sorted(jzspecs.specs)}")
    for path, spec in zspecs.specs.items():
        theirs = dataclasses.asdict(jzspecs.specs[path])
        if dataclasses.asdict(spec) != theirs:
            raise ValueError(f"QSpec of {path!r} differs: port "
                             f"{dataclasses.asdict(spec)}, JAX {theirs}")
    return zspecs


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
                                device="cuda"):
    """The port's round state from numpy ``scores`` (f32 scores or the
    codec's u8/u16 words, as ``encode_state`` carries them) and
    ``dense`` dicts keyed by the JAX package's path strings; each dense
    leaf in its template's dtype (bf16 leaves of an LM through f32)."""
    return state_to(zspecs, {"scores": {p: np.asarray(scores[p])
                                        for p in zspecs.specs},
                             "dense": {p: np.asarray(dense[p])
                                       for p in zspecs.dense_paths}},
                    resolve_device(device))


def federated_state_from_jax(jzspecs, jstate, *, device="cuda"):
    """(the port's ZamplingSpecs, its round state) for a JAX
    ``ZamplingSpecs`` and a JAX federated state (``encode_state``'s
    output, or an f32 ``init_state``)."""
    zspecs = zspecs_from_jax(jzspecs)
    return zspecs, federated_state_from_arrays(
        zspecs, jstate["scores"], jstate["dense"], device=device)


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
