"""Counter-based deterministic hash RNG, in torch.

The same streams as the JAX package's ``core/hashrng.py``: murmur3's
fmix32 finalizer over an xxhash-style running combine.  Every consumer
(the plain torch path and the CUDA kernels in ``csrc/qz_common.cuh``)
regenerates the influence matrix Q and the mask draws from these words.

torch has no usable uint32 shift, add or compare, so tensors carry
uint32 values in int64 and every step masks with ``& 0xFFFFFFFF``.  The
products by the 32-bit constants are split into 16-bit halves so no
intermediate leaves int64's range.  This is the same code on the CPU
and on the card.

Static words (Python or numpy ints) fold in Python, as the JAX
package folds them at trace time; a static result is a Python int.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_K1 = 0x9E3779B9  # golden-ratio increment
_K2 = 0x165667B1
H0 = 0x2545F491

INV_2_24 = float(np.float32(1.0 / (1 << 24)))
TWO_PI = float(np.float32(6.283185307179586))


def is_static(x) -> bool:
    return isinstance(x, (int, np.integer))


def mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 ``h`` in [0, 2^32) and a static
    32-bit ``c``, without leaving int64's range."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fmix32(h):
    """murmur3 32-bit finalizer. Static int or int64 tensor."""
    if is_static(h):
        h = int(h) & _M32
        h ^= h >> 16
        h = (h * _C1) & _M32
        h ^= h >> 13
        h = (h * _C2) & _M32
        h ^= h >> 16
        return h
    h = h ^ (h >> 16)
    h = mul32(h, _C1)
    h = h ^ (h >> 13)
    h = mul32(h, _C2)
    return h ^ (h >> 16)


def _combine(h, w):
    """h' = (h ^ fmix32(w + K1)) * K2 + K1 (mod 2^32)."""
    if is_static(w):
        mixed = fmix32((int(w) + _K1) & _M32)
    else:
        mixed = fmix32((w.to(torch.int64) + _K1) & _M32)
    if is_static(h) and is_static(mixed):
        return ((int(h) ^ mixed) * _K2 + _K1) & _M32
    return (mul32(h ^ mixed, _K2) + _K1) & _M32


def hash_fold(h, *words):
    """Running combine state after ``words``, starting from state ``h``
    (``H0`` for a fresh hash); shared prefixes fold once."""
    for w in words:
        h = _combine(h, w)
    return h


def hash_u32(*words):
    """Combine integer words (static ints or int64 tensors holding
    uint32 values) into one uint32 word, broadcasting the tensors.

    ``hash_u32(seed, tensor_id, row, counter)`` is the Q generator's
    call.  A static prefix folds to one Python int.
    """
    return fmix32(hash_fold(H0, *words))


def u32_to_uniform(u: torch.Tensor) -> torch.Tensor:
    """uint32 (in int64) -> float32 uniform in (0, 1]."""
    return (u >> 8).to(torch.float32) * INV_2_24 + INV_2_24


def gaussian_from_u32(u_a: torch.Tensor, u_b: torch.Tensor) -> torch.Tensor:
    """Two uint32 streams -> standard normal by Box-Muller (cos branch)."""
    u1 = u32_to_uniform(u_a)
    u2 = u32_to_uniform(u_b)
    r = torch.sqrt(torch.log(u1) * -2.0)
    return r * torch.cos(u2 * TWO_PI)


def bernoulli_u32(u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """uint32 stream + probabilities -> {0, 1} float32 draws."""
    return (u32_to_uniform(u) <= p).to(torch.float32)
