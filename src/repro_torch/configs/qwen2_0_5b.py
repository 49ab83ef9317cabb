"""qwen2-0.5b — GQA, QKV bias [arXiv:2407.10671].

24L d_model=896, 14H GQA kv=2, d_ff=4864, vocab=151936.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    vocab=151936,
    n_heads=14,
    n_kv=2,
    d_ff=4864,
    qkv_bias=True,
    tie_embeddings=True,
    source="arXiv:2407.10671",
)
