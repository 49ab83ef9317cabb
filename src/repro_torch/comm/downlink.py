"""Downlink codecs: the wire format of the server's score broadcast.

The ``f32``, ``u16`` and ``u8`` codecs of the JAX package's
``comm/downlink.py``.  A quantized codec sends
``q = floor(p * S + 1/4 + dither / 2)`` with ``S = 2^b - 1`` and a
shared dither in [0, 1) from the hash stream (words ``(spec.seed,
spec.tensor_id, QUANT_DITHER_CTR, word, coord)``), and decodes to the
exact threshold value ``quant_threshold_u24(q, b) * 2^-24``.

The encode keeps the multiply and the two adds as separate torch ops,
in the JAX package's order: a fused multiply-add could move the floor
at a boundary.

The packed sub-byte codecs (``packed4``/``packed2``, aliases
``u4``/``u2``; ``packed_codec(b)`` for any b in [1, 16]) quantize
exactly as ``u8``/``u16`` do and carry ``floor(32/b)`` words a uint32
lane (``comm.bitpack.pack_words``), so their wire leaf has
``packed_word_len(n, b)`` lanes and the metering counts the realized
``32 * ceil(n / wpl)`` bits, padding included.  Every packed codec's
wire dtype is uint32, so the dtype cannot name one: ``codec_for_dtype``
raises on uint32, and packed carries are routed by explicit tag
(``carried=``, ``downlink=``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .bitpack import (pack_words, packed_word_len, unpack_words,
                      words_per_lane)
from ..core.hashrng import INV_2_24, hash_u32
from ..core.sampling import QUANT_DITHER_CTR, as_word, clip_probs
from ..core.sampling import quant_threshold_u24, word_values


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

    def wire_len(self, n: int) -> int:
        """Length of the wire leaf of an n-coordinate score vector: n,
        or the lane count of a packed codec."""
        return n

    def encode(self, spec, scores: torch.Tensor, word,
               coord0: int = 0) -> torch.Tensor:
        """Scores of the coordinates [coord0, coord0 + n) (a model rank's
        slice of a sharded leaf, or all of them) -> their wire leaf."""
        raise NotImplementedError

    def decode(self, spec, wire: torch.Tensor, n=None) -> torch.Tensor:
        """A wire leaf of n coordinates (spec.n by default) -> f32."""
        raise NotImplementedError

    def wire_words(self, spec, wire: torch.Tensor, n=None) -> torch.Tensor:
        """Wire leaf of n coordinates (spec.n by default) ->
        per-coordinate words (the leaf itself, or the unpacked lanes of a
        packed codec)."""
        del spec, n
        return wire

    def threshold_u24(self, words: torch.Tensor) -> torch.Tensor:
        """Per-coordinate words -> the 24-bit draw thresholds."""
        raise NotImplementedError(
            f"codec {self.name!r} has no quantized threshold")


class F32Down(DownlinkCodec):
    """Identity: the f32 score vector itself."""

    name = "f32"

    def encode(self, spec, scores, word, coord0=0):
        del spec, word, coord0
        return scores

    def decode(self, spec, wire, n=None):
        del spec, n
        return wire


class QuantizedDown(DownlinkCodec):
    """b-bit probability words with a shared dither."""

    quantized = True

    def __init__(self, name: str, bits: int, wire_dtype):
        self.name = name
        self.bits = bits
        self.wire_dtype = wire_dtype
        self.scale = float((1 << bits) - 1)

    def dither(self, spec, word, n: int, device,
               coord0: int = 0) -> torch.Tensor:
        """The shared dither in [0, 1) at coordinates coord0..coord0+n-1."""
        coords = torch.arange(coord0, coord0 + n, dtype=torch.int64,
                              device=device)
        u = hash_u32(spec.seed, spec.tensor_id, QUANT_DITHER_CTR,
                     as_word(word), coords)
        return (u >> 8).to(torch.float32) * INV_2_24

    def quantize(self, spec, scores, word, coord0: int = 0) -> torch.Tensor:
        """f32 scores -> the b-bit words, int32."""
        p = clip_probs(scores.to(torch.float32))
        d = self.dither(spec, word, p.shape[-1], p.device, coord0)
        # floor(p*S + 0.25 + 0.5*d), each op rounded on its own
        q = torch.floor((p * self.scale + 0.25) + d * 0.5)
        return torch.clamp(q, 0.0, self.scale).to(torch.int32)

    def wire_of_words(self, q: torch.Tensor) -> torch.Tensor:
        """Per-coordinate words (int32/int64) -> this codec's wire leaf."""
        if self.wire_dtype == torch.uint16:
            # through int16: torch's CUDA kernels take few ops on uint16
            return q.to(torch.int16).view(torch.uint16)
        return q.to(self.wire_dtype)

    def encode(self, spec, scores, word, coord0=0):
        return self.wire_of_words(self.quantize(spec, scores, word, coord0))

    def encode_at(self, spec, scores, word, bits,
                  coord0: int = 0) -> torch.Tensor:
        """The scheduled encode: quantize at width ``bits`` (an int, or a
        0-d int64 tensor on the scores' device) no wider than the codec,
        then widen into the codec's words.

        ``q_b = floor(p * S_b + 1/4 + dither/2)`` with ``S_b = 2^b - 1``
        and ``encode``'s dither, widened exactly to ``q = (q_b * S +
        S_b // 2) // S_b`` (``S`` the codec's scale): ``encode``'s words
        at ``bits == self.bits``.  The carry keeps the codec's layout, so
        every reader of the words stays as it is; only b bits a
        coordinate are metered (``comm.metering.scheduled_wire_metrics``).
        """
        p = clip_probs(scores.to(torch.float32))
        d = self.dither(spec, word, p.shape[-1], p.device, coord0)
        b = torch.as_tensor(bits, dtype=torch.int64, device=p.device)
        s_b = (1 << b) - 1
        s_bf = s_b.to(torch.float32)
        q_b = torch.floor((p * s_bf + 0.25) + d * 0.5)
        q_b = torch.minimum(torch.maximum(q_b, q_b.new_zeros(())), s_bf)
        q = (q_b.to(torch.int64) * ((1 << self.bits) - 1) + s_b // 2) // s_b
        return self.wire_of_words(q)

    def threshold_u24(self, words):
        return quant_threshold_u24(word_values(words), self.bits)

    def decode(self, spec, wire, n=None):
        words = self.wire_words(spec, wire, n)
        return self.threshold_u24(words).to(torch.float32) * INV_2_24


class PackedDown(QuantizedDown):
    """b-bit words, b in [1, 16], packed ``floor(32/b)`` a uint32 lane:
    ``QuantizedDown``'s words and thresholds on another carrier."""

    packed = True

    def __init__(self, name: str, bits: int):
        super().__init__(name, bits, torch.uint32)

    def downlink_bits_per_client(self, n: int) -> int:
        # realized lane bits: the tail lane's padding and the unused top
        # 32 mod b bits of a non-divisor width are spent
        return 32 * packed_word_len(n, self.bits)

    def wire_len(self, n: int) -> int:
        return packed_word_len(n, self.bits)

    def wire_of_words(self, q):
        return pack_words(q, self.bits)

    def wire_words(self, spec, wire, n=None):
        return unpack_words(wire, spec.n if n is None else n, self.bits)


_REGISTRY: Dict[str, DownlinkCodec] = {}
_ALIASES: Dict[str, str] = {}


def register_codec(codec: DownlinkCodec,
                   aliases: Tuple[str, ...] = ()) -> DownlinkCodec:
    """Add a codec (and alias names) to the registry."""
    _REGISTRY[codec.name] = codec
    for a in aliases:
        _ALIASES[a] = codec.name
    return codec


def codec_names(include_aliases: bool = True) -> List[str]:
    """The registered codecs' names, then their aliases."""
    names = sorted(_REGISTRY)
    return names + sorted(_ALIASES) if include_aliases else names


def packed_codec(bits: int) -> PackedDown:
    """The ``packed{b}`` codec for a width b in [1, 16], registered at
    first use (``packed4`` and ``packed2`` are registered already)."""
    words_per_lane(bits)  # the range check
    name = f"packed{bits}"
    if name not in _REGISTRY:
        register_codec(PackedDown(name, bits))
    return _REGISTRY[name]


def codec_for_dtype(dtype: torch.dtype) -> DownlinkCodec:
    """The codec whose wire leaves carry ``dtype``: floating leaves are
    f32 scores, uint8/uint16 the u8/u16 words.  uint32 is every packed
    codec's carrier, so it names none and raises: route packed carries
    by explicit tag."""
    if dtype.is_floating_point:
        return _REGISTRY["f32"]
    matches = [c for c in _REGISTRY.values()
               if c.quantized and c.wire_dtype == dtype]
    if len(matches) > 1:
        raise ValueError(
            f"dtype {dtype} is ambiguous between downlink codecs "
            f"{', '.join(sorted(c.name for c in matches))}; route by "
            "explicit tag (the carried=/downlink= argument)")
    if matches:
        return matches[0]
    raise ValueError(f"no downlink codec carries dtype {dtype}; registered: "
                     f"{', '.join(codec_names())}")


def get_codec(name: str) -> DownlinkCodec:
    canonical = _ALIASES.get(name, name)
    if canonical not in _REGISTRY:
        raise ValueError(f"unknown downlink codec {name!r}; registered: "
                         f"{', '.join(codec_names())}")
    return _REGISTRY[canonical]


register_codec(F32Down())
register_codec(QuantizedDown("u16", 16, torch.uint16))
register_codec(QuantizedDown("u8", 8, torch.uint8))
register_codec(PackedDown("packed4", 4), aliases=("u4",))
register_codec(PackedDown("packed2", 2), aliases=("u2",))


def encode(codec: str, spec, scores: torch.Tensor, word) -> torch.Tensor:
    return get_codec(codec).encode(spec, scores, word)


def decode(codec: str, spec, wire: torch.Tensor) -> torch.Tensor:
    return get_codec(codec).decode(spec, wire)
