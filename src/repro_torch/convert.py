"""Carry the JAX package's serving state across to the port.

The JAX package's ``ServeState`` holds ``words`` and ``dense`` dicts
keyed by path strings and a uint32 draw word ``step``; as numpy arrays
they become the port's ``ServeState`` under the same paths.  bf16
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

from .core.zampling import ZamplingConfig, ZamplingSpecs, build_specs
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
