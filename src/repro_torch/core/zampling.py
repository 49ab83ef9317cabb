"""Zampling over a model's parameter template: which leaves get a QSpec.

``build_specs`` walks a template of parameter shapes and gives every
large (>= 2-D, >= ``min_size`` weights) leaf a QSpec; the rest stay
dense.  A leaf's ``tensor_id`` is its index in the JAX package's
tree-flatten order, which sorts dict keys at every level: the id keys
every hash stream, so the port must number leaves in that same order.

Scores come in from outside (numpy arrays, a JAX state through
``repro_torch.convert``): ``init_state`` takes them, where the JAX
package's draws them with ``jax.random``, which has no torch twin.

``MaskProgram`` is the mask lifecycle: scores in, weights or upload
lanes out (``kernels.ops``).  ``mode`` is ``sample`` (a fresh
Bernoulli mask per forward pass), ``continuous`` (the expected
network, w = Q p) or ``discretize`` (w = Q 1[p >= 0.5]).  Sample mode
with ``fused`` draws inside the reconstruct kernel; every other
combination is the composed path: the explicit straight-through mask
(``masks``), then ``weights_from_masks`` on the reconstruct kernels.
Fused and composed give the same weights and gradients bit for bit.
A score leaf of shape (n,) is one client with one draw word; (K, n) is
K clients with K draw words, which is how the federated round calls it
(the JAX package vmaps a single client).  Reconstructed leaves come out
in their template dtype (``LeafSpec.dtype``), cast from the kernels'
f32; dense leaves are carried in it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from ..device import as_tensor, resolve_device
from .qspec import QSpec, make_qspec
from .sampling import (as_word, as_words, clip_probs, discretize_mask,
                       sample_mask_hash, sample_mask_qhash,
                       sample_mask_st_hash)

MASK_MODES = ("sample", "continuous", "discretize")


class LeafSpec(NamedTuple):
    """Shape and dtype name of one parameter leaf."""

    shape: tuple
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


@dataclass(frozen=True)
class ZamplingConfig:
    """Reparametrization hyper-parameters (the JAX package's fields)."""

    compression: float = 32.0  # m/n
    d: int = 8  # non-zeros per row of Q
    window: int = 512  # z-window size
    seed: int = 0  # shared seed for Q
    min_size: int = 1024  # leaves smaller than this stay dense
    mode: str = "sample"
    chunks: int = 1
    shard_align: int = 1


@dataclass(frozen=True)
class ZamplingSpecs:
    """Static spec set for one model."""

    specs: Dict[str, QSpec]
    dense_paths: Tuple[str, ...]
    template: Dict[str, LeafSpec]  # flat {path: LeafSpec}, flatten order
    config: ZamplingConfig

    @property
    def m_total(self) -> int:
        return sum(s.m for s in self.specs.values())

    @property
    def n_total(self) -> int:
        return sum(s.n for s in self.specs.values())

    @property
    def dense_total(self) -> int:
        return sum(math.prod(self.template[p].shape) for p in self.dense_paths)


def _as_leaf(leaf) -> LeafSpec:
    if isinstance(leaf, LeafSpec):
        return leaf
    if hasattr(leaf, "shape"):
        return LeafSpec(tuple(int(s) for s in leaf.shape),
                        str(getattr(leaf, "dtype", "float32")))
    return LeafSpec(tuple(int(s) for s in leaf))


def _nest(flat: Dict[str, object]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return tree


def flatten(tree: dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) pairs in the JAX tree-flatten order of a dict tree:
    keys sorted at every level.  A flat ``{"a/b": leaf}`` dict is
    nested first, so both spellings give the same order."""
    if any("/" in k for k in tree):
        tree = _nest(tree)
    for key in sorted(tree):
        node = tree[key]
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(node, dict):
            yield from flatten(node, path)
        else:
            yield path, node


def default_fan_in(path: str, shape) -> int:
    """Fan-in of the target neuron: the product of all-but-last dims;
    embedding tables use the model dim."""
    if len(shape) < 2:
        return max(int(shape[0]) if shape else 1, 1)
    if "embed" in path.lower():
        return int(shape[-1])
    fan = 1
    for s in shape[:-1]:
        fan *= int(s)
    return max(fan, 1)


def build_specs(template: dict, config: ZamplingConfig,
                fan_in_fn: Callable[[str, tuple], int] = default_fan_in
                ) -> ZamplingSpecs:
    """Assign a QSpec to every large leaf of a shape template.

    ``template``: nested or flat (``"a/b"`` paths) dict whose leaves
    are shapes, ``LeafSpec``s, or anything with ``.shape``.
    """
    specs: Dict[str, QSpec] = {}
    dense = []
    flat: Dict[str, LeafSpec] = {}
    for tid, (path, leaf) in enumerate(flatten(template)):
        leaf = _as_leaf(leaf)
        flat[path] = leaf
        m = 1
        for s in leaf.shape:
            m *= int(s)
        if len(leaf.shape) >= 2 and m >= config.min_size:
            specs[path] = make_qspec(
                tid, leaf.shape, fan_in_fn(path, leaf.shape),
                compression=config.compression, d=config.d,
                window=config.window, seed=config.seed,
                align=config.shard_align)
        else:
            dense.append(path)
    return ZamplingSpecs(specs=specs, dense_paths=tuple(dense),
                         template=flat, config=config)


# ---------------------------------------------------------------------------
# State on a device, and the codec a score dict carries
# ---------------------------------------------------------------------------

def state_to(zspecs: ZamplingSpecs, state, device) -> Dict[str, Any]:
    """``{"scores": {path: (n,) scores or wire words}, "dense": {path:
    leaf in its template dtype}}`` from numpy arrays or tensors, on
    ``device``; any other key of ``state`` is left out."""
    return {"scores": {p: as_tensor(state["scores"][p], device)
                       for p in zspecs.specs},
            "dense": {p: as_tensor(state["dense"][p], device,
                                   zspecs.template[p].torch_dtype)
                      for p in zspecs.dense_paths}}


def init_state(zspecs: ZamplingSpecs, scores, dense_init=None, *,
               device="cuda") -> Dict[str, Any]:
    """``{"scores": {path: (n,) f32}, "dense": {path: leaf}}`` on
    ``device``, from given scores (numpy or tensors, one (n,) leaf per
    zampled path).  ``dense_init``: a nested or flat dict of real
    parameters to take dense leaves from; a dense leaf it lacks is ones
    where the path names a scale or norm, else zeros (the JAX package's
    ``init_state`` heuristics)."""
    for path, spec in zspecs.specs.items():
        if tuple(scores[path].shape) != (spec.n,):
            raise ValueError(f"scores of {path!r} have shape "
                             f"{tuple(scores[path].shape)}, spec expects "
                             f"({spec.n},)")
    given = dict(flatten(dense_init)) if dense_init is not None else {}
    dense = {}
    for path in zspecs.dense_paths:
        if path in given:
            dense[path] = given[path]
        else:
            leaf = zspecs.template[path]
            fill = (torch.ones if "scale" in path or "norm" in path.lower()
                    else torch.zeros)
            dense[path] = fill(leaf.shape)
    return state_to(zspecs, {"scores": {p: as_tensor(scores[p], "cpu",
                                                     torch.float32)
                                        for p in zspecs.specs},
                             "dense": dense}, resolve_device(device))


def infer_downlink(scores) -> str:
    """The codec a score dict carries, from its leaves' dtypes."""
    from ..comm.downlink import codec_for_dtype  # comm sits above core

    names = {codec_for_dtype(v.dtype).name for v in scores.values()}
    if len(names) > 1:
        raise ValueError(f"score leaves mix downlink codecs {sorted(names)}")
    return names.pop() if names else "f32"


def validate_carried(zspecs: ZamplingSpecs, scores, carried: str) -> str:
    """Check an explicit codec tag against the leaves' dtype and length;
    returns the codec's name."""
    from ..comm.downlink import get_codec

    codec = get_codec(carried)
    for path, spec in zspecs.specs.items():
        leaf = scores[path]
        if codec.quantized:
            ok = leaf.dtype == codec.wire_dtype and leaf.shape[-1] == spec.n
        else:
            ok = leaf.dtype.is_floating_point
        if not ok:
            raise ValueError(
                f"score leaf {path!r} (dtype {leaf.dtype}, trailing dim "
                f"{leaf.shape[-1]}) cannot carry the tagged codec "
                f"{codec.name!r} (n={spec.n})")
    return codec.name


def resolve_carried(zspecs: ZamplingSpecs, scores,
                    carried: Optional[str] = None) -> str:
    """An explicit tag, validated; else the codec the dtypes name."""
    if carried is not None:
        return validate_carried(zspecs, scores, carried)
    return infer_downlink(scores)


# ---------------------------------------------------------------------------
# The mask program
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MaskProgram:
    """The configured mask lifecycle over a spec set (``mode`` x
    ``fused``).  ``packed`` picks the upload's form: uint32 wire lanes,
    or the f32 {0,1} mask.  ``downlink`` names the codec of the server's
    broadcast; the ``*_from_wire`` path draws straight from its u8/u16
    words."""

    zspecs: ZamplingSpecs
    mode: str = "sample"
    fused: bool = True
    packed: bool = False
    downlink: str = "f32"
    impl: Optional[str] = None  # kernels.ops impl override

    def __post_init__(self):
        if self.mode not in MASK_MODES:
            raise ValueError(f"unknown mask mode {self.mode!r}; valid "
                             f"modes: {', '.join(MASK_MODES)}")

    @property
    def codec(self):
        from ..comm.downlink import get_codec  # comm sits above core

        return get_codec(self.downlink)

    def _wire_words(self, wire_scores, path: str) -> torch.Tensor:
        codec = self.codec
        q = wire_scores[path]
        if q.dtype != codec.wire_dtype:
            raise ValueError(
                f"score leaf {path!r} has dtype {q.dtype}, but downlink "
                f"codec {codec.name!r} carries {codec.wire_dtype}; encode "
                "the state first (core.federated.encode_state)")
        return q

    def decode_scores(self, wire_scores) -> Dict[str, torch.Tensor]:
        """Encoded broadcast -> the client's f32 trainable scores
        (the same tensors under the ``f32`` codec)."""
        codec = self.codec
        if not codec.quantized:
            return dict(wire_scores)
        return {path: codec.decode(spec, self._wire_words(wire_scores, path))
                for path, spec in self.zspecs.specs.items()}

    # -- the composed path ---------------------------------------------
    def mask(self, p: torch.Tensor, spec: QSpec, step) -> torch.Tensor:
        """One tensor's mask from CLIPPED probabilities ``p``: the
        straight-through draw at ``step`` (a word for (n,), K words for
        (K, n)), ``p`` itself, or the rounded mask."""
        if self.mode == "sample":
            if p.ndim == 2:
                step = as_words(step, p.device)
            return sample_mask_st_hash(p, spec.seed, spec.tensor_id, step)
        if self.mode == "continuous":
            return p
        return discretize_mask(p)

    def masks(self, scores, step) -> Dict[str, torch.Tensor]:
        """{path: mask}, one fresh draw per tensor at ``step``."""
        return {path: self.mask(clip_probs(scores[path]), spec, step)
                for path, spec in self.zspecs.specs.items()}

    def mask_from_wire(self, q: torch.Tensor, spec: QSpec, step):
        """One tensor's mask from its encoded broadcast words: in sample
        mode the u8/u16 threshold compare (bit-identical to drawing on
        the decoded scores); otherwise the mode's mask of the decoded
        probabilities."""
        codec = self.codec
        if codec.quantized and self.mode == "sample":
            words = as_words(step, q.device) if q.ndim == 2 else as_word(step)
            return sample_mask_qhash(q, codec.bits, spec.seed,
                                     spec.tensor_id, words)
        return self.mask(clip_probs(codec.decode(spec, q)), spec, step)

    def masks_from_wire(self, wire_scores, step) -> Dict[str, torch.Tensor]:
        """{path: mask} drawn directly from the encoded broadcast."""
        return {path: self.mask_from_wire(self._wire_words(wire_scores, path),
                                          spec, step)
                for path, spec in self.zspecs.specs.items()}

    # -- weights -------------------------------------------------------
    def weights(self, scores, dense, steps) -> Dict[str, torch.Tensor]:
        """{path: leaf} of one forward pass: a fresh draw at ``steps``
        (a word for (n,) scores, K words for (K, n) scores)."""
        if not (self.fused and self.mode == "sample"):
            return weights_from_masks(self.zspecs, self.masks(scores, steps),
                                      {"dense": dense}, impl=self.impl)
        from ..kernels import ops  # kernels sit above core

        leaves = {}
        for path, spec in self.zspecs.specs.items():
            p = clip_probs(scores[path])
            op = (ops.sample_reconstruct_batched if p.ndim == 2
                  else ops.sample_reconstruct)
            leaves[path] = _as_template(self.zspecs, path,
                                        op(spec, p, steps, impl=self.impl))
        leaves.update({path: dense[path] for path in self.zspecs.dense_paths})
        return leaves

    def upload(self, scores, steps) -> Dict[str, torch.Tensor]:
        """The end-of-round upload of sample mode: fresh gradient-free
        bits at ``steps``, as wire lanes when ``packed`` (drawn in the
        pack kernel when ``fused``), else f32 masks."""
        if self.mode != "sample":
            raise NotImplementedError(
                f"the upload of mode={self.mode!r} is not ported yet; it "
                "comes with the federated continuous/discretize modes")
        from ..comm.bitpack import pack_mask  # comm sits above core
        from ..kernels import ops

        out = {}
        for path, spec in self.zspecs.specs.items():
            p = clip_probs(scores[path].detach())
            if self.packed and self.fused:
                op = (ops.sample_pack_batched if p.ndim == 2
                      else ops.sample_pack)
                out[path] = op(spec, p, steps, impl=self.impl)
                continue
            words = (as_words(steps, p.device) if p.ndim == 2
                     else as_word(steps))
            z = sample_mask_hash(p, spec.seed, spec.tensor_id, words)
            out[path] = pack_mask(z) if self.packed else z
        return out

    def weights_from_wire(self, wire_scores, dense,
                          steps) -> Dict[str, torch.Tensor]:
        """One forward pass drawn straight from the encoded broadcast:
        in fused sample mode the u8/u16 threshold compare in the kernel,
        no f32 scores.  Gradient-free; training decodes first
        (``decode_scores``)."""
        codec = self.codec
        if not codec.quantized:
            return self.weights(wire_scores, dense, steps)
        if not (self.fused and self.mode == "sample"):
            return weights_from_masks(
                self.zspecs, self.masks_from_wire(wire_scores, steps),
                {"dense": dense}, impl=self.impl)
        from ..kernels import ops

        leaves = {}
        for path, spec in self.zspecs.specs.items():
            q = self._wire_words(wire_scores, path)
            op = (ops.sample_reconstruct_batched if q.ndim == 2
                  else ops.sample_reconstruct)
            leaves[path] = _as_template(self.zspecs, path, op(
                spec, q, steps, qbits=codec.bits, impl=self.impl))
        leaves.update({path: dense[path] for path in self.zspecs.dense_paths})
        return leaves


def _as_template(zspecs: ZamplingSpecs, path: str, w: torch.Tensor):
    """A reconstructed f32 leaf in its template dtype (bf16 at full
    width), cast outside the reconstruct op as the JAX package casts
    it, so the kernels see f32 cotangents."""
    return w.to(zspecs.template[path].torch_dtype)


def weights_from_masks(zspecs: ZamplingSpecs, masks, state, *,
                       impl: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """{path: leaf}: every zampled leaf reconstructed from its mask
    ((n,) on ``ops.reconstruct``, (K, n) on ``ops.reconstruct_batched``),
    the dense leaves from ``state["dense"]``."""
    from ..kernels import ops  # kernels sit above core

    leaves = {}
    for path, spec in zspecs.specs.items():
        z = masks[path]
        op = ops.reconstruct_batched if z.ndim == 2 else ops.reconstruct
        leaves[path] = _as_template(zspecs, path, op(spec, z, impl=impl))
    leaves.update({path: state["dense"][path] for path in zspecs.dense_paths})
    return leaves


def _program(zspecs: ZamplingSpecs, st, mode, fused, downlink, carried,
             impl) -> MaskProgram:
    from ..comm.downlink import get_codec

    resolved = resolve_carried(zspecs, st["scores"], carried)
    if downlink is not None and get_codec(downlink).name != resolved:
        raise ValueError(f"downlink={downlink!r} does not match the state's "
                         f"score representation ({resolved!r})")
    return MaskProgram(zspecs, mode=mode or zspecs.config.mode, fused=fused,
                       downlink=resolved, impl=impl)


def sample_masks(zspecs: ZamplingSpecs, state, key, *,
                 mode: Optional[str] = None,
                 carried: Optional[str] = None,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """{path: z} straight-through masks, one fresh draw per tensor at
    the draw word ``key``; a u8/u16 carry draws by the threshold
    compare."""
    st = state_to(zspecs, state, resolve_device(device))
    program = _program(zspecs, st, mode, False, None, carried, None)
    return program.masks_from_wire(st["scores"], as_word(key))


def sample_weights(zspecs: ZamplingSpecs, state, key, *,
                   mode: Optional[str] = None,
                   downlink: Optional[str] = None,
                   carried: Optional[str] = None,
                   impl: Optional[str] = None,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """One network, {path: leaf}: sampled at the draw word ``key``, or
    the expected (``mode="continuous"``) or discretized network, which
    draw nothing.
    ``state["scores"]`` holds f32 scores or a codec's wire words
    (``carried`` names the codec; without it the dtypes do); an
    explicit ``downlink`` must agree with what the state carries."""
    st = state_to(zspecs, state, resolve_device(device))
    program = _program(zspecs, st, mode, True, downlink, carried, impl)
    return program.weights_from_wire(st["scores"], st["dense"], as_word(key))
