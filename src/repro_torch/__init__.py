"""PyTorch + CUDA port of the Zampling system, beside the JAX package.

Modules mirror ``repro``'s names.  The port imports torch and numpy,
never jax and nothing of ``repro``.

Importing the package settles torch's CPU transcendentals first
(``_settle_cpu_transcendentals``): with an MKL build of torch, a
process's first multi-threaded ``log``/``exp``/``cos``/``sin`` call (f32
or f64) can give wrong values on one intra-op thread's share of the
tensor (about 1 fresh process in 15: up to 1.5e-4 absolute on ``cos``;
every later call is right).  A first call on one element, in one
thread, takes that first call's place, so the CPU Box-Muller
(``core.hashrng.gaussian_from_u32``) gives the same bits in every
process at any thread count.  CUDA tensors are untouched.
"""

import torch as _torch


def _settle_cpu_transcendentals() -> None:
    """One single-threaded call of each CPU transcendental the port
    computes with, in f32 and f64, before any value is kept."""
    for dtype in (_torch.float32, _torch.float64):
        one = _torch.ones(1, dtype=dtype)
        for fn in (_torch.log, _torch.exp, _torch.cos, _torch.sin):
            fn(one)


_settle_cpu_transcendentals()
