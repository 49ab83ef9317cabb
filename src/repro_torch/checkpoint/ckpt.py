"""Checkpoints: a state dict <-> npz with path-flattened keys and a JSON
sidecar, in the JAX package's ``checkpoint/ckpt.py`` layout, so either
package reads the other's files.

The npz keys are the JAX tree-flatten paths of the state: keys sorted at
every dict level and joined by ``/`` (``scores/<leaf path>``,
``dense/<leaf path>``, ``downlink_b``); ``np.savez_compressed`` writes
them.  ``<stem>.meta.json`` holds the caller's meta, the codec tag under
``meta['downlink']`` and every leaf's dtype under ``__leaf_dtypes__``.

Leaves load at the SAVED dtype, never the template's: f32 scores, u8/u16
wire words, a packed codec's uint32 lanes, the frontier schedule's
uint32 widths ``downlink_b``.  The template fixes only the structure.
The port carries ``downlink_b`` as int64 (``core.zampling.state_to``)
and writes it as the JAX package's uint32.

bf16 needs no ``ml_dtypes``: a bf16 leaf is written as its uint16 bits
viewed as ``np.dtype('V2')`` (what ``np.savez`` makes of an
``ml_dtypes`` bf16 array) with ``bfloat16`` in the sidecar, and read
back by viewing those bytes as uint16 and then as ``torch.bfloat16``.

Route loaded score words by the codec tag (``checkpoint_downlink``,
then ``serve.make_serve_state(..., carried=tag)``), never by dtype: a
uint32 carry names no single packed codec.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..device import as_tensor, resolve_device

_DTYPES_KEY = "__leaf_dtypes__"
DOWNLINK_KEY = "downlink"
_WIDTHS_KEY = "downlink_b"  # the frontier's widths: uint32 on the wire


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in the JAX tree-flatten order of nested dicts: keys
    sorted at every level."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)


def _to_numpy(key: str, leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(np.dtype("V2"))
    if key == _WIDTHS_KEY:
        t = t.to(torch.uint32)
    return t.numpy()


def _dtype_name(arr: np.ndarray) -> str:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return "bfloat16"
    return str(arr.dtype)


def _stem(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def save_checkpoint(path: str, tree: Any, meta: Optional[Dict] = None, *,
                    downlink: Optional[str] = None) -> None:
    """Write ``tree`` (nested dicts of tensors or arrays) as npz plus the
    JSON sidecar.  ``downlink`` names the codec of an encoded score carry
    in ``tree``; it is checked against the codec registry (as one given
    in ``meta`` is) and recorded as ``meta['downlink']``."""
    meta = dict(meta or {})
    if downlink is not None:
        if DOWNLINK_KEY in meta and meta[DOWNLINK_KEY] != downlink:
            raise ValueError(
                f"conflicting codec tags: downlink={downlink!r} vs "
                f"meta['downlink']={meta[DOWNLINK_KEY]!r}")
        meta[DOWNLINK_KEY] = downlink
    if DOWNLINK_KEY in meta:
        from ..comm.downlink import get_codec  # comm sits above checkpoint

        get_codec(meta[DOWNLINK_KEY])  # an unknown name raises here
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {k: _to_numpy(k, v) for k, v in _leaves(tree)}
    np.savez_compressed(path, **arrays)
    meta[_DTYPES_KEY] = {k: _dtype_name(v) for k, v in arrays.items()}
    with open(_stem(path) + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2, default=str)


def _rebuild(template, leaves: Dict[str, torch.Tensor], prefix: str = ""):
    if not isinstance(template, dict):
        return leaves[prefix]
    return {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else k)
            for k, v in template.items()}


def load_checkpoint(path: str, template: Any, *,
                    device="cuda") -> Tuple[Any, Dict]:
    """Restore into the structure of ``template`` (the port's nested
    state dict), every leaf a tensor on ``device`` at its SAVED dtype
    (the sidecar's record; the npz arrays' own dtypes where a sidecar
    lacks one).  Returns (tree, meta) without the dtype record."""
    dev = resolve_device(device)
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    meta = {}
    meta_path = _stem(path) + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    dtypes = meta.pop(_DTYPES_KEY, {})
    leaves = {}
    for key, _ in _leaves(template):
        arr = data[key]
        saved = dtypes.get(key)
        if saved is not None and saved != "bfloat16":
            arr = arr.astype(np.dtype(saved))
        leaves[key] = as_tensor(arr, dev)  # a |V2 leaf is bf16's bits
    return _rebuild(template, leaves), meta


def checkpoint_downlink(meta: Dict) -> Optional[str]:
    """The codec tag of a loaded checkpoint's score carry, checked
    against the registry; None for a checkpoint without one."""
    name = meta.get(DOWNLINK_KEY)
    if name is None:
        return None
    from ..comm.downlink import get_codec

    get_codec(name)
    return name
