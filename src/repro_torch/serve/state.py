"""Serving state: the encoded score words as the only zampled state.

A serving node holds, per zampled leaf, the downlink codec's words
(u8/u16, or f32 scores under the ``f32`` codec), one uint32 draw word
pinning the mask draw, and the small dense leaves (norm scales,
biases).  The streaming engine contracts activations against the words
directly (``kernels.ops.serve_matmul``); no weight tensor exists.

Dense leaves are kept in float32: the engine's activations are float32
(the streamed projections return float32), and a bf16 leaf widens to
float32 exactly, as JAX widens it when it adds it to a float32 value.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch

from ..comm.downlink import get_codec
from ..core.sampling import as_word
from ..core.zampling import ZamplingSpecs, infer_downlink
from ..device import as_tensor, resolve_device


@dataclass(frozen=True)
class ServeState:
    """One serving node's model state."""

    zspecs: ZamplingSpecs
    codec: str  # 'f32' | 'u16' | 'u8'
    words: Mapping[str, torch.Tensor]  # path -> (n,) encoded words
    dense: Mapping[str, torch.Tensor]  # path -> float32 dense leaf
    step: int  # uint32 mask draw word

    @property
    def qbits(self) -> Optional[int]:
        codec = get_codec(self.codec)
        return codec.bits if codec.quantized else None

    @property
    def device(self) -> torch.device:
        return next(iter(self.words.values())).device

    def arrays(self) -> Dict[str, object]:
        return {"words": dict(self.words), "dense": dict(self.dense),
                "step": self.step}

    def resident_zampled_bytes(self) -> int:
        """Resident zampled bytes in streaming mode: the words (+4 for
        the draw word)."""
        return sum(w.numel() * w.element_size()
                   for w in self.words.values()) + 4


def make_serve_state(zspecs: ZamplingSpecs, state, key, *,
                     downlink: Optional[str] = None, dither_word=0,
                     carried: Optional[str] = None,
                     device="cuda") -> ServeState:
    """Build a ServeState from ``state = {"scores": {path: scores or
    words}, "dense": {path: leaf}}`` (numpy arrays or tensors).

    ``key``: the integer draw word pinning the serving mask draw.
    ``downlink``: target codec (default: what the scores carry).  f32
    scores are encoded on ``device`` with ``dither_word`` keying the
    dither.  ``carried`` names the codec the leaves already carry.
    """
    dev = resolve_device(device)
    scores = {p: as_tensor(state["scores"][p], dev) for p in zspecs.specs}
    found = infer_downlink(scores)
    if carried is not None and get_codec(carried).name != found:
        raise ValueError(f"score leaves carry {found!r}, tagged "
                         f"{carried!r}")
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
    for p, spec in zspecs.specs.items():
        if words[p].shape != (spec.n,):
            raise ValueError(f"words of {p!r} have shape "
                             f"{tuple(words[p].shape)}, spec n={spec.n}")
    dense = {p: as_tensor(state["dense"][p], dev, torch.float32)
             for p in zspecs.dense_paths}
    return ServeState(zspecs=zspecs, codec=target, words=words, dense=dense,
                      step=as_word(key))
