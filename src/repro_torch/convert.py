"""Carry the JAX package's serving and federated states across to the port.

The JAX package's ``ServeState`` holds ``words`` and ``dense`` dicts
keyed by path strings and a uint32 draw word ``step``; as numpy arrays
they become the port's ``ServeState`` under the same paths.  A
federated round state ``{"scores": {path: f32 scores or u8/u16 wire
words}, "dense": {path: leaf}}`` becomes the same dict of tensors.  bf16
leaves (``ml_dtypes`` arrays) widen to float32.  The port's spec set is
rebuilt from the JAX template's shapes and config, and every QSpec is
checked field by field against the JAX one, so a mismatch in leaf order
(and so in tensor ids) raises here rather than serving other weights.

Duck-typed: this module imports neither jax nor the JAX package; it
reads attributes and converts with ``numpy.asarray``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .core.zampling import (ZamplingConfig, ZamplingSpecs, build_specs,
                            state_to)
from .device import resolve_device
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
    ``dense`` dicts keyed by the JAX package's path strings."""
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
