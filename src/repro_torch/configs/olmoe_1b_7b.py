"""olmoe-1b-7b — 64 experts top-8 [arXiv:2409.02060].

16L d_model=2048, 16H kv=16, expert d_ff=1024, vocab=50304.
"""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    vocab=50304,
    n_heads=16,
    n_kv=16,
    d_ff=0,
    qk_norm=True,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
    source="arXiv:2409.02060",
)
