"""Re-export shim: the plain reconstruction references live in
``core.reconstruct``.

The JAX package keeps ``kernels/ref.py`` as the same shim, so every
import path it has has a twin here.
"""

from ..core.reconstruct import (grad_z_ref, materialize_q,  # noqa: F401
                                reconstruct_ref)

__all__ = ["reconstruct_ref", "materialize_q", "grad_z_ref"]
