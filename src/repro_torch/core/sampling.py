"""Mask-draw primitives: the counter spaces, the clip, the mask stream
and the quantized-word threshold, as in the JAX package's
``core/sampling.py``.

The bit at coordinate ``j`` of tensor ``tensor_id`` under draw word
``step`` is ``1[uniform(hash_u32(seed, tensor_id, MASK_CTR, step, j))
<= p_j]``; for b-bit wire words it is the integer compare
``(hash >> 8) < quant_threshold_u24(q, b)``.
"""

from __future__ import annotations

import torch

from .hashrng import hash_u32, is_static

# Counter space of the mask stream: words (seed, tensor_id, MASK_CTR,
# step, coord), disjoint from qspec's (seed, tensor_id, row, ctr).
MASK_CTR = 0x0008_0000

# Counter space of the downlink-quantization dither stream: words
# (seed, tensor_id, QUANT_DITHER_CTR, word, coord).
QUANT_DITHER_CTR = 0x0010_0000


def clip_probs(s: torch.Tensor) -> torch.Tensor:
    """p = f(s), the ReLU clipped at 1."""
    return torch.clamp(s, 0.0, 1.0)


def as_word(word) -> int:
    """A plain integer draw word as a uint32 Python int.

    The JAX package also folds PRNG keys into words (``key_word``);
    the port has no PRNG keys, so callers pass integers.
    """
    if isinstance(word, torch.Tensor):
        if word.numel() != 1:
            raise TypeError("a draw word is one integer, got a tensor of "
                            f"shape {tuple(word.shape)}")
        word = int(word.item())
    if not is_static(word):
        raise TypeError(f"a draw word is an integer, got {type(word)}")
    return int(word) & 0xFFFFFFFF


def mask_u32(seed: int, tensor_id: int, step, coords: torch.Tensor):
    """The uint32 mask stream (in int64) at the given coordinates."""
    return hash_u32(seed, tensor_id, MASK_CTR, step, coords)


def quant_threshold_u24(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Widen a b-bit probability word to the 24-bit draw threshold,
    ``T(q) = floor(q * 2^24 / (2^bits - 1))``, exactly, as
    ``a + a // S`` with ``a = q << (24 - bits)``."""
    if not 1 <= bits <= 24:
        raise ValueError(f"quantized probability words need 1..24 bits, "
                         f"got {bits}")
    a = q.to(torch.int64) << (24 - bits)
    return a + a // ((1 << bits) - 1)
