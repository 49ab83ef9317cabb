"""mixtral-8x7b — 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

32L d_model=4096, 32H GQA kv=8, expert d_ff=14336, vocab=32000, SWA 4096
(native — so long_500k runs with a ring-buffer KV cache).
"""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    vocab=32000,
    n_heads=32,
    n_kv=8,
    d_ff=0,
    window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
    source="arXiv:2401.04088",
)
