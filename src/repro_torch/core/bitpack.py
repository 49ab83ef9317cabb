"""Re-export shim: the packing helpers live in ``comm.bitpack``.

The JAX package keeps ``core/bitpack.py`` as the same shim, so every
import path it has has a twin here.
"""

from ..comm.bitpack import (pack_mask, packed_len,  # noqa: F401
                            packed_popcount_sum, unpack_mask)

__all__ = ["pack_mask", "packed_len", "packed_popcount_sum", "unpack_mask"]
