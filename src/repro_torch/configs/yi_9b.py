"""yi-9b — llama-arch GQA [arXiv:2403.04652].

48L d_model=4096, 32H GQA kv=4, d_ff=11008, vocab=64000.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    vocab=64000,
    n_heads=32,
    n_kv=4,
    d_ff=11008,
    source="arXiv:2403.04652",
)
