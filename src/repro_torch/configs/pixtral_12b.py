"""pixtral-12b — pixtral-ViT + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409].

40L d_model=5120, 32H GQA kv=8, d_ff=14336, vocab=131072.  The vision
encoder + projector are STUBBED per the brief: ``input_specs`` feeds
precomputed patch/text embeddings of shape (B, S, d_model) to the
decoder (``embed_stub=True``).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    vocab=131072,
    n_heads=32,
    n_kv=8,
    head_dim=160,
    d_ff=14336,
    rope_theta=1_000_000.0,
    embed_stub=True,
    source="hf:mistralai/Pixtral-12B-2409",
)
