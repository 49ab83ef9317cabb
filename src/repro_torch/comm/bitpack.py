"""Bit-packing: the uplink's mask lanes and the downlink's word lanes.

The JAX package's ``comm/bitpack.py``.  A client uploads its mask
``z in {0,1}^n`` as 32 bits per uint32 lane: bit j of lane i is
coordinate ``32*i + j``.  Mask lanes are carried as int64 tensors
holding the uint32 value, as the port carries every hash word, so all
the arithmetic here is exact integer arithmetic.  Every function takes
arbitrary leading batch axes: a (K, n) client slab packs to (K, L).

The sub-byte downlink codecs pack b-bit words, b in [1, 16], into
uint32 lanes: ``wpl = floor(32 / b)`` words a lane, word j of lane i
coordinate ``i*wpl + j`` at bit offset ``b*j``.  A width that does not
divide 32 leaves the top ``32 mod b`` bits of every lane unused.  These
lanes are the round's carried state, so they are ``torch.uint32``
tensors holding the bytes of the JAX package's uint32 carry; torch has
no uint32 shifts on the CPU, so the arithmetic runs on an int32 view
widened to int64.
"""

from __future__ import annotations

import torch


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def packed_len(n: int) -> int:
    """uint32 lanes needed for an n-bit mask."""
    return (n + 31) // 32


def pack_mask(z: torch.Tensor) -> torch.Tensor:
    """{0,1} mask ``(..., n)`` (float/bool/int) -> ``(..., ceil(n/32))``
    lanes (int64 holding uint32); bit j of lane i is coordinate 32i+j."""
    n = z.shape[-1]
    pad = packed_len(n) * 32 - n
    bits = torch.nn.functional.pad(z.to(torch.int64), (0, pad))
    bits = bits.reshape(*z.shape[:-1], -1, 32)
    return (bits << _shifts(z.device)).sum(-1)


def unpack_mask(packed: torch.Tensor, n: int,
                dtype=torch.float32) -> torch.Tensor:
    """Lanes ``(..., ceil(n/32))`` -> ``(..., n)`` mask in ``dtype``."""
    bits = (packed.to(torch.int64)[..., None] >> _shifts(packed.device)) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :n].to(dtype)


def packed_popcount_sum(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Per-coordinate vote counts from K clients' lanes: (K, L) -> (n,)
    int64, entry j the number of clients whose bit j is set."""
    bits = (packed.to(torch.int64)[:, :, None] >> _shifts(packed.device)) & 1
    return bits.sum(0).reshape(-1)[:n]


def packed_weighted_sum(packed: torch.Tensor, n: int,
                        weights: torch.Tensor) -> torch.Tensor:
    """Weighted per-coordinate vote counts: (K, L) lanes and (K,)
    integer weights -> (n,) int64, entry j the sum of the weights of the
    clients whose bit j is set.  Exact integers, so any order of the sum
    gives the same counts; weights all 1 give ``packed_popcount_sum``'s.
    One bit position at a time, so no (K, L, 32) temporary is built."""
    lanes = packed.to(torch.int64)
    w = weights.to(device=lanes.device, dtype=torch.int64)[:, None]
    counts = torch.stack([(((lanes >> j) & 1) * w).sum(0)
                          for j in range(32)], dim=-1)  # (L, 32)
    return counts.reshape(-1)[:n]


def packed_weighted_fold(acc: torch.Tensor, packed: torch.Tensor, n: int,
                         weights: torch.Tensor) -> torch.Tensor:
    """Fold one chunk of C uploads, (C, L) lanes with (C,) weights, into
    the (n,) int64 vote counts so far: the streaming form of
    ``packed_weighted_sum``, the same counts for any chunking."""
    return acc + packed_weighted_sum(packed, n, weights)


def packed_total_popcount(packed: torch.Tensor) -> torch.Tensor:
    """Set bits over the trailing lane axis, leading axes kept, as int64:
    an upload's checksum (``fault.validate``)."""
    x = packed.to(torch.int64)
    x = x - ((x >> 1) & 0x55555555)  # a lane's popcount, SWAR
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum(-1)


# ---------------------------------------------------------------------------
# b-bit word lanes (the packed downlink codecs)
# ---------------------------------------------------------------------------

def words_per_lane(bits: int) -> int:
    """b-bit words per uint32 lane: floor(32 / b)."""
    if not 1 <= bits <= 16:
        raise ValueError(f"packed word width must be 1..16 bits, got {bits}")
    return 32 // bits


def packed_word_len(n: int, bits: int) -> int:
    """uint32 lanes needed for n b-bit words: ceil(n / floor(32/b))."""
    wpl = words_per_lane(bits)
    return (n + wpl - 1) // wpl


def _lanes_to_int64(lanes: torch.Tensor) -> torch.Tensor:
    """uint32 lanes -> int64 holding the same values (through int32)."""
    return lanes.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _int64_to_lanes(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> uint32 lanes (through int32)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(
        torch.int32).view(torch.uint32)


def pack_words(q: torch.Tensor, bits: int) -> torch.Tensor:
    """b-bit words ``(..., n)`` (any integer dtype, values < 2^b) ->
    ``(..., packed_word_len(n, b))`` uint32 lanes; word j of lane i is
    coordinate ``i*wpl + j`` at bit offset ``b*j``."""
    wpl = words_per_lane(bits)
    n = q.shape[-1]
    pad = packed_word_len(n, bits) * wpl - n
    words = torch.nn.functional.pad(q.to(torch.int64), (0, pad))
    words = words.reshape(*q.shape[:-1], -1, wpl)
    shifts = bits * torch.arange(wpl, dtype=torch.int64, device=q.device)
    return _int64_to_lanes((words << shifts).sum(-1))


def unpack_words(lanes: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """uint32 lanes ``(..., packed_word_len(n, b))`` -> ``(..., n)``
    b-bit words as int64, the exact inverse of ``pack_words`` (the
    trailing lane's padding dropped)."""
    wpl = words_per_lane(bits)
    shifts = bits * torch.arange(wpl, dtype=torch.int64, device=lanes.device)
    words = (_lanes_to_int64(lanes)[..., None] >> shifts) & ((1 << bits) - 1)
    return words.reshape(*lanes.shape[:-1], -1)[..., :n]
