"""Architecture config schema (the JAX package's ``configs/base.py``).

One ``ArchConfig`` fully determines a model: the decoder/encoder stack,
attention flavour (GQA, qkv-bias, qk-norm, sliding window), MoE and SSM
blocks, and modality front-end stubs.  ``reduced()`` returns the
CI-scale variant used by the per-arch smoke tests (2 layers,
d_model <= 512, <= 4 experts) — same family, same code paths.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    n_groups: int = 1


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec archs (Seamless)."""

    n_layers: int = 12
    n_heads: int = 16
    n_kv: int = 16
    d_ff: int = 4096


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0  # 0 for attention-free
    n_kv: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    d_ff: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None  # sliding-window size (Mixtral 4096)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    # hybrid (Zamba2): one SHARED attention block applied every k layers
    attn_every: int = 0
    # modality stub: model consumes precomputed embeddings, not token ids
    embed_stub: bool = False
    dtype: str = "bfloat16"
    source: str = ""  # citation

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to 256 so embed/lm_head shard over 'model'
        (unpadded 50280-style vocabs force full-logit replication —
        measured 13 GB/device f32 at 4k seq). CE masks the pad columns."""
        return ((self.vocab + 255) // 256) * 256

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv, max(1, n_heads // 2)) if self.n_kv else 0
        moe = None
        if self.moe is not None:
            moe = replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 128),
            )
        ssm = None
        if self.ssm is not None:
            ssm = replace(self.ssm, d_state=min(self.ssm.d_state, 16),
                          headdim=32, chunk=16)
        enc = None
        if self.encoder is not None:
            enc = replace(self.encoder, n_layers=2, n_heads=4, n_kv=4,
                          d_ff=128)
        return replace(
            self,
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv=n_kv,
            head_dim=64 if self.n_heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            window=min(self.window, 64) if self.window else None,
            moe=moe,
            ssm=ssm,
            encoder=enc,
            attn_every=2 if self.attn_every else 0,
            dtype="float32",
        )
