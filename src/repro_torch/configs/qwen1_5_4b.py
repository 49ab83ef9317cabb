"""qwen1.5-4b — QKV bias [hf:Qwen/Qwen1.5-0.5B family].

40L d_model=2560, 20H kv=20 (MHA), d_ff=6912, vocab=151936.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    vocab=151936,
    n_heads=20,
    n_kv=20,
    d_ff=6912,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)
