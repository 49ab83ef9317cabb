"""Serving state: the encoded score words as the only zampled state
(the JAX package's ``serve/state.py``).

A serving node holds, per zampled leaf, the downlink codec's words
(u8/u16, f32 scores under the ``f32`` codec, or a packed codec's uint32
lanes), one uint32 draw word pinning the mask draw, and the small dense
leaves (norm scales, biases).  The streaming engine contracts
activations against the words directly (``kernels.ops.serve_matmul``);
no weight tensor exists.  ``reconstruct_resident`` materializes every
leaf once for ``mode="load"`` (kernel 7 on a CUDA tensor), with the
weights the streaming path regenerates.  Round-to-round updates arrive
as XOR deltas of the words (``serve.delta``); ``replace_arrays`` swaps
the patched words into a live server.

Dense leaves are kept in float32: the engine's activations are float32
(the streamed projections return float32), and a bf16 leaf widens to
float32 exactly, as JAX widens it when it adds it to a float32 value.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Mapping, Optional

import torch

from ..comm.downlink import get_codec
from ..core.sampling import as_word, clip_probs
from ..core.zampling import ZamplingSpecs, infer_downlink, validate_carried
from ..device import as_tensor, resolve_device


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass(frozen=True)
class ServeState:
    """One serving node's model state."""

    zspecs: ZamplingSpecs
    codec: str  # a downlink codec's name
    words: Mapping[str, torch.Tensor]  # path -> encoded words or lanes
    dense: Mapping[str, torch.Tensor]  # path -> float32 dense leaf
    step: int  # uint32 mask draw word

    @property
    def qbits(self) -> Optional[int]:
        codec = get_codec(self.codec)
        return codec.bits if codec.quantized else None

    @property
    def qpacked(self) -> bool:
        """True when the words are a packed codec's uint32 lanes."""
        return bool(get_codec(self.codec).packed)

    @property
    def device(self) -> torch.device:
        return next(iter(self.words.values())).device

    def arrays(self) -> Dict[str, object]:
        return {"words": dict(self.words), "dense": dict(self.dense),
                "step": self.step}

    def replace_arrays(self, arrays: Dict[str, object]) -> "ServeState":
        """New state with swapped arrays (the hot-swap entry point)."""
        return replace(self, words=dict(arrays["words"]),
                       dense=dict(arrays["dense"]),
                       step=as_word(arrays["step"]))

    def resident_zampled_bytes(self) -> int:
        """Resident zampled bytes in streaming mode: the words (+4 for
        the draw word)."""
        return sum(_nbytes(w) for w in self.words.values()) + 4

    def loaded_zampled_bytes(self) -> int:
        """Resident zampled bytes in load mode: the f32 leaves."""
        return sum(4 * s.m for s in self.zspecs.specs.values())

    def dense_bytes(self) -> int:
        return sum(_nbytes(v) for v in self.dense.values())


def make_serve_state(zspecs: ZamplingSpecs, state, key, *,
                     downlink: Optional[str] = None, dither_word=0,
                     carried: Optional[str] = None,
                     device="cuda") -> ServeState:
    """Build a ServeState from ``state = {"scores": {path: scores or
    words}, "dense": {path: leaf}}`` (numpy arrays or tensors).

    ``key``: the integer draw word pinning the serving mask draw.
    ``downlink``: target codec (default: what the scores carry).  f32
    scores are encoded on ``device`` with ``dither_word`` keying the
    dither; servers that broadcast deltas reuse one dither word across
    rounds, so unchanged scores keep unchanged words.  ``carried`` names
    the codec the leaves already carry, checked against their dtype and
    length (``validate_carried``); without it the dtypes name it, which
    a packed carry's uint32 lanes cannot.
    """
    dev = resolve_device(device)
    scores = {p: as_tensor(state["scores"][p], dev) for p in zspecs.specs}
    found = (validate_carried(zspecs, scores, carried) if carried is not None
             else infer_downlink(scores))
    target = get_codec(downlink or found).name
    if target == found:
        words = scores
    elif found != "f32":
        raise ValueError(f"state already carries codec {found!r}; decode "
                         f"before re-encoding as {target!r}")
    else:
        codec = get_codec(target)
        words = {p: codec.encode(spec, scores[p], dither_word)
                 for p, spec in zspecs.specs.items()}
    codec = get_codec(target)
    for p, spec in zspecs.specs.items():
        if words[p].shape != (codec.wire_len(spec.n),):
            raise ValueError(f"words of {p!r} have shape "
                             f"{tuple(words[p].shape)}, codec {target!r} "
                             f"carries ({codec.wire_len(spec.n)},)")
    dense = {p: as_tensor(state["dense"][p], dev, torch.float32)
             for p in zspecs.dense_paths}
    return ServeState(zspecs=zspecs, codec=target, words=words, dense=dense,
                      step=as_word(key))


def reconstruct_resident(sstate: ServeState,
                         impl: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Reconstruct-on-load: every zampled leaf materialized once,
    {path: W (spec.shape) f32}, the resident state of ``mode="load"``.
    ``ops.sample_reconstruct`` from the words (kernel 7 on a CUDA
    tensor), with the weights the streaming path regenerates, so the
    two modes serve the same bits."""
    from ..kernels import ops  # kernels sit above comm/core

    qbits, qpacked = sstate.qbits, sstate.qpacked
    out = {}
    for path, spec in sstate.zspecs.specs.items():
        w = sstate.words[path]
        operand = w if qbits is not None else clip_probs(w.to(torch.float32))
        out[path] = ops.sample_reconstruct(spec, operand, sstate.step,
                                           qbits=qbits, qpacked=qpacked,
                                           impl=impl)
    return out
