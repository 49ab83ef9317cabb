"""Mask-draw primitives: the counter spaces, the clip, draw words, the
mask stream, the discretized mask and the quantized-word threshold, as
in the JAX package's ``core/sampling.py``.

The bit at coordinate ``j`` of tensor ``tensor_id`` under draw word
``step`` is ``1[uniform(hash_u32(seed, tensor_id, MASK_CTR, step, j))
<= p_j]``; for b-bit wire words it is the integer compare
``(hash >> 8) < quant_threshold_u24(q, b)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .hashrng import bernoulli_u32, hash_u32, is_static

# Counter space of the mask stream: words (seed, tensor_id, MASK_CTR,
# step, coord), disjoint from qspec's (seed, tensor_id, row, ctr).
MASK_CTR = 0x0008_0000

# Counter space of the downlink-quantization dither stream: words
# (seed, tensor_id, QUANT_DITHER_CTR, word, coord).
QUANT_DITHER_CTR = 0x0010_0000


def clip_probs(s: torch.Tensor) -> torch.Tensor:
    """p = f(s), the ReLU clipped at 1.

    Written as maximum then minimum, whose gradient at a tie is 0.5, as
    ``jax.grad`` of ``jnp.clip`` gives at s = 0 and s = 1 (``torch.clamp``
    gives 1 there).  Decoded u8 broadcasts put many scores exactly on
    those boundaries, so the straight-through gradient depends on it.
    """
    return torch.minimum(torch.maximum(s, s.new_zeros(())), s.new_ones(()))


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


def as_words(steps, device) -> torch.Tensor:
    """Draw words (ints, a sequence, numpy, or a tensor already holding
    uint32 values) as an int64 tensor on ``device``."""
    if isinstance(steps, torch.Tensor):
        return steps.to(device=device, dtype=torch.int64)
    arr = np.asarray(steps, dtype=np.uint64) & np.uint64(0xFFFFFFFF)
    return torch.as_tensor(arr.astype(np.int64), device=device)


def fold_word(word, *counters):
    """Derive a sub-word: hash-combine counters into a draw word (a
    Python int for static words, else an int64 tensor)."""
    return hash_u32(word, *counters)


def mask_u32(seed: int, tensor_id: int, step, coords: torch.Tensor):
    """The uint32 mask stream (in int64) at the given coordinates."""
    return hash_u32(seed, tensor_id, MASK_CTR, step, coords)


def _draw_words(step, n: int, device):
    """(step word(s), coordinates) shaped to broadcast: a (K,) step
    tensor draws one row of n coordinates per entry."""
    coords = torch.arange(n, dtype=torch.int64, device=device)
    if isinstance(step, torch.Tensor) and step.ndim:
        step = step.to(device=device, dtype=torch.int64)[..., None]
    elif not isinstance(step, torch.Tensor):
        step = as_word(step)
    return step, coords


def sample_mask_hash(p: torch.Tensor, seed: int, tensor_id: int, step):
    """z ~ Bern(p) from the hash stream, float32 in {0, 1}; ``p`` is
    (..., n) with coordinates last and ``step`` a word or a tensor of
    words broadcasting against the leading axes.  No gradient."""
    step, coords = _draw_words(step, p.shape[-1], p.device)
    return bernoulli_u32(mask_u32(seed, tensor_id, step, coords), p.detach())


def sample_mask_st_hash(p: torch.Tensor, seed: int, tensor_id: int, step):
    """Straight-through hash Bernoulli: forward z, backward identity."""
    z = sample_mask_hash(p, seed, tensor_id, step)
    return p + (z - p).detach()


def discretize_mask(p: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest mask (paper App. A 'discretized network'):
    1[p >= 0.5] in float32, no gradient."""
    return (p >= 0.5).to(torch.float32)


def word_values(q: torch.Tensor) -> torch.Tensor:
    """uint8/uint16 wire words as int32 values (uint16 through an int16
    view: torch's CUDA kernels take few ops on uint16)."""
    if q.dtype == torch.uint16:
        return q.view(torch.int16).to(torch.int32) & 0xFFFF
    return q.to(torch.int32)


def sample_mask_qhash(q: torch.Tensor, bits: int, seed: int, tensor_id: int,
                      step):
    """z ~ Bern(T(q) / 2^24) drawn straight from b-bit wire words: the
    integer compare ``(hash >> 8) < quant_threshold_u24(q, bits)``,
    bit-identical to ``sample_mask_hash`` on the decoded probability."""
    step, coords = _draw_words(step, q.shape[-1], q.device)
    u = mask_u32(seed, tensor_id, step, coords)
    return ((u >> 8) < quant_threshold_u24(word_values(q), bits)).to(
        torch.float32)


def quant_threshold_u24(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Widen a b-bit probability word to the 24-bit draw threshold,
    ``T(q) = floor(q * 2^24 / (2^bits - 1))``, exactly, as
    ``a + a // S`` with ``a = q << (24 - bits)``."""
    if not 1 <= bits <= 24:
        raise ValueError(f"quantized probability words need 1..24 bits, "
                         f"got {bits}")
    a = q.to(torch.int64) << (24 - bits)
    return a + a // ((1 << bits) - 1)
