"""zamba2-7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81 Mamba2 layers, d_model=3584, ssm_state=64; ONE shared attn+MLP block
(32H kv=32, d_ff=14336) applied every 6 mamba layers with reused
weights, vocab=32000.
"""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    vocab=32000,
    n_heads=32,
    n_kv=32,
    d_ff=14336,
    attn_every=6,
    ssm=SSMConfig(d_state=64, headdim=64, expand=2, conv_width=4, chunk=128),
    source="arXiv:2411.15242",
)
