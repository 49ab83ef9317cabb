"""Bit-packing of binary masks: the uplink's wire lanes.

The JAX package's ``comm/bitpack.py``.  A client uploads its mask
``z in {0,1}^n`` as 32 bits per uint32 lane: bit j of lane i is
coordinate ``32*i + j``.  Lanes are carried as int64 tensors holding
the uint32 value, as the port carries every hash word, so all the
arithmetic here is exact integer arithmetic.  Every function takes
arbitrary leading batch axes: a (K, n) client slab packs to (K, L).
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
