"""Downlink codecs: the wire format of the server's score broadcast.

The ``f32``, ``u16`` and ``u8`` codecs of the JAX package's
``comm/downlink.py``.  A quantized codec sends
``q = floor(p * S + 1/4 + dither / 2)`` with ``S = 2^b - 1`` and a
shared dither in [0, 1) from the hash stream (words ``(spec.seed,
spec.tensor_id, QUANT_DITHER_CTR, word, coord)``), and decodes to the
exact threshold value ``quant_threshold_u24(q, b) * 2^-24``.

The encode keeps the multiply and the two adds as separate torch ops,
in the JAX package's order: a fused multiply-add could move the floor
at a boundary.  The packed sub-byte codecs are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..core.hashrng import INV_2_24, hash_u32
from ..core.sampling import QUANT_DITHER_CTR, as_word, clip_probs
from ..core.sampling import quant_threshold_u24


class DownlinkCodec:
    """One downlink wire format."""

    name: str = "?"
    bits: int = 32
    wire_dtype = torch.float32
    quantized: bool = False
    packed: bool = False

    def downlink_bits_per_client(self, n: int) -> int:
        """Exact bits the server puts on the wire per client for an
        n-coordinate score broadcast."""
        return self.bits * n

    def encode(self, spec, scores: torch.Tensor, word) -> torch.Tensor:
        raise NotImplementedError

    def decode(self, spec, wire: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class F32Down(DownlinkCodec):
    """Identity: the f32 score vector itself."""

    name = "f32"

    def encode(self, spec, scores, word):
        del spec, word
        return scores

    def decode(self, spec, wire):
        del spec
        return wire


class QuantizedDown(DownlinkCodec):
    """b-bit probability words with a shared dither."""

    quantized = True

    def __init__(self, name: str, bits: int, wire_dtype):
        self.name = name
        self.bits = bits
        self.wire_dtype = wire_dtype
        self.scale = float((1 << bits) - 1)

    def dither(self, spec, word, n: int, device) -> torch.Tensor:
        """The shared dither in [0, 1) at coordinates 0..n-1."""
        coords = torch.arange(n, dtype=torch.int64, device=device)
        u = hash_u32(spec.seed, spec.tensor_id, QUANT_DITHER_CTR,
                     as_word(word), coords)
        return (u >> 8).to(torch.float32) * INV_2_24

    def encode(self, spec, scores, word):
        p = clip_probs(scores.to(torch.float32))
        d = self.dither(spec, word, p.shape[-1], p.device)
        # floor(p*S + 0.25 + 0.5*d), each op rounded on its own
        q = torch.floor((p * self.scale + 0.25) + d * 0.5)
        q = torch.clamp(q, 0.0, self.scale)
        q = q.to(torch.int32)
        if self.wire_dtype == torch.uint16:
            # through int16: torch's CUDA kernels take few ops on uint16
            return q.to(torch.int16).view(torch.uint16)
        return q.to(self.wire_dtype)

    def decode(self, spec, wire):
        del spec
        if wire.dtype == torch.uint16:
            wire = wire.view(torch.int16).to(torch.int32) & 0xFFFF
        return quant_threshold_u24(wire, self.bits).to(
            torch.float32) * INV_2_24


_REGISTRY: Dict[str, DownlinkCodec] = {
    c.name: c for c in (F32Down(), QuantizedDown("u16", 16, torch.uint16),
                        QuantizedDown("u8", 8, torch.uint8))
}
_LATER = ("packed4", "packed2", "u4", "u2")


def codec_names() -> List[str]:
    """The ported codecs' names (the packed ones come later)."""
    return sorted(_REGISTRY)


def codec_for_dtype(dtype: torch.dtype) -> DownlinkCodec:
    """The codec whose wire leaves carry ``dtype``: floating leaves are
    f32 scores, uint8/uint16 the u8/u16 words."""
    if dtype.is_floating_point:
        return _REGISTRY["f32"]
    for codec in _REGISTRY.values():
        if codec.quantized and codec.wire_dtype == dtype:
            return codec
    raise ValueError(f"no downlink codec carries dtype {dtype}")


def get_codec(name: str) -> DownlinkCodec:
    if name in _LATER:
        raise NotImplementedError(
            f"downlink codec {name!r} (packed sub-byte lanes) is not "
            "ported yet; the port carries f32, u16 and u8")
    if name not in _REGISTRY:
        raise ValueError(f"unknown downlink codec {name!r}; registered: "
                         f"{', '.join(sorted(_REGISTRY))}")
    return _REGISTRY[name]


def encode(codec: str, spec, scores: torch.Tensor, word) -> torch.Tensor:
    return get_codec(codec).encode(spec, scores, word)


def decode(codec: str, spec, wire: torch.Tensor) -> torch.Tensor:
    return get_codec(codec).decode(spec, wire)
