"""Sharding rules: path/shape -> the mesh axes each dim is split over.

The JAX package's ``launch/sharding.py``.  The rules are pure shape
rules, so the port keeps them as they are; a placement is ``P``, a
tuple with one entry a dim: an axis name, a tuple of axis names, or
None (replicated).

 - batch dims  -> ("pod","data") (replicated when not divisible, e.g.
   long_500k's batch=1);
 - vocab/embedding rows, MoE expert axis, d_ff/heads (last or
   second-to-last dim) -> "model", first divisible dim wins; a
   down-projection and attention-out shard their input dim (the
   Megatron pairing with the column-parallel producer);
 - score vectors / masks (1-D, window-aligned) -> "model";
 - KV caches: batch -> data axes, kv-heads -> "model" when divisible
   (GQA kv<16 falls back to head_dim, then the sequence dim);
 - everything small/non-divisible -> replicated.

A rule reads ``mesh.axis_names`` and ``mesh.axis_size`` only
(``launch.mesh.Mesh``).  The port's zampled leaves honour one placement
of "model": on the leaf's major axis (``core.zampling.build_specs`` with
``shard_plan_fn``), the block each model rank reconstructs.
"""

from __future__ import annotations

from typing import Dict, Tuple

P = tuple  # a placement: one entry a dim (axis name, tuple of names, None)


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _data_entry(mesh):
    """The data axes as one placement entry: a name alone, as JAX's
    PartitionSpec spells a one-axis tuple, else the tuple."""
    axes = _data_axes(mesh)
    return axes[0] if len(axes) == 1 else axes


def _data_size(mesh) -> int:
    n = 1
    for a in _data_axes(mesh):
        n *= mesh.axis_size(a)
    return n


def param_spec(path: str, shape, mesh) -> P:
    """A parameter's placement on ``mesh``."""
    ms = mesh.axis_size("model")
    ndim = len(shape)
    dims = [None] * ndim
    if ndim == 0:
        return ()
    pl = path.lower()
    if ndim == 1:
        # score/mask vectors are window-aligned; shard when divisible
        if ("scores" in pl or "mask" in pl) and shape[0] % ms == 0:
            return ("model",)
        return ()
    # embedding tables: shard vocab rows
    if "embed" in pl and shape[-2] % ms == 0:
        dims[-2] = "model"
        return tuple(dims)
    # MoE expert stacks (L, E, a, b): prefer expert parallelism
    if ndim >= 3 and any(t in pl for t in ("gate", "up", "down")) and (
            "moe" in pl or ndim == 4):
        e_dim = ndim - 3
        if shape[e_dim] % ms == 0:
            dims[e_dim] = "model"
            return tuple(dims)
    # Megatron pairing: down-proj and attention-out are row-parallel
    order = ((ndim - 2, ndim - 1)
             if any(t in pl for t in ("down", "wo")) else
             (ndim - 1, ndim - 2))
    for d in order:
        if shape[d] % ms == 0 and shape[d] >= ms:
            dims[d] = "model"
            return tuple(dims)
    return ()


def batch_spec(path: str, shape, mesh) -> P:
    """Model inputs: shard the leading (batch) dim over the data axes."""
    del path
    if not shape:
        return ()
    dn = _data_size(mesh)
    dims: list = [None] * len(shape)
    if shape[0] % dn == 0 and shape[0] >= dn:
        dims[0] = _data_entry(mesh)
    return tuple(dims)


def cache_spec(path: str, shape, mesh) -> P:
    """KV/SSM caches, stacked (L, B, ...): B -> data, heads/seq -> model."""
    del path
    ndim = len(shape)
    if ndim < 3:
        return ()
    ms = mesh.axis_size("model")
    dn = _data_size(mesh)
    dims: list = [None] * ndim
    if shape[1] % dn == 0 and shape[1] >= dn:
        dims[1] = _data_entry(mesh)
    # a head-like dim (dim 3 of (L,B,C,KV,hd) / (L,B,H,P,N)), then
    # head_dim; the seq dim (2) last: the decode ring-buffer write at a
    # traced slot forces copies across a seq-sharded cache
    for d in (3, ndim - 1, 2):
        if 1 < d < ndim and shape[d] % ms == 0 and shape[d] >= ms:
            dims[d] = "model"
            break
    return tuple(dims)


_RULES = {"param": param_spec, "input": batch_spec, "cache": cache_spec}


def plan_tree(tree: dict, mesh, kind: str) -> Dict[str, P]:
    """{path: placement} of a flat ``{"a/b": leaf}`` (or nested) dict whose
    leaves are shapes or have ``.shape``, by the rule of ``kind``
    (param | input | cache)."""
    from ..core.zampling import flatten

    rule = _RULES[kind]
    return {path: rule(path, tuple(getattr(leaf, "shape", leaf)), mesh)
            for path, leaf in flatten(tree)}


def replicated(mesh) -> P:
    """The placement of a replicated value (any rank, any mesh)."""
    del mesh
    return ()


def shard_map_specs(tree: dict, manual_axes: Tuple[str, ...],
                    batch_dim0: bool) -> Dict[str, P]:
    """Per-leaf placements over the manual axes only: a leaf's leading
    dim over ``manual_axes`` with ``batch_dim0`` (where it has at least
    as many entries as there are axes), else replicated."""
    from ..core.zampling import flatten

    out = {}
    entry = manual_axes[0] if len(manual_axes) == 1 else tuple(manual_axes)
    for path, leaf in flatten(tree):
        shape = tuple(getattr(leaf, "shape", leaf))
        if batch_dim0 and shape and shape[0] >= len(manual_axes):
            out[path] = (entry,) + (None,) * (len(shape) - 1)
        else:
            out[path] = ()
    return out


def model_axis_of(spec: P):
    """The dim a placement splits over 'model', or None."""
    for i, entry in enumerate(spec):
        if entry == "model" or (isinstance(entry, tuple) and "model" in entry):
            return i
    return None
