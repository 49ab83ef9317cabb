"""seamless-m4t-medium — enc-dec, multimodal [arXiv:2308.11596].

12L decoder, d_model=1024, 16H kv=16, d_ff=4096, vocab=256206; 12-layer
encoder consuming STUBBED mel/conv frame embeddings (B, S/4, d_model)
via ``input_specs`` (the conv-codec front-end is the documented stub).
"""

from .base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    vocab=256206,
    n_heads=16,
    n_kv=16,
    d_ff=4096,
    encoder=EncoderConfig(n_layers=12, n_heads=16, n_kv=16, d_ff=4096),
    embed_stub=True,
    source="arXiv:2308.11596",
)
