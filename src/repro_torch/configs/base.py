"""Architecture config schema (the JAX package's ``configs/base.py``).

One ``ArchConfig`` fully determines a model: the decoder/encoder stack,
attention flavour (GQA, qkv-bias, qk-norm, sliding window), MoE and SSM
blocks, and modality front-end stubs.  ``reduced()`` returns the
CI-scale variant used by the per-arch smoke tests (2 layers,
d_model <= 512, <= 4 experts) — same family, same code paths.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


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

    def supports_shape(self, shape_name: str) -> Tuple[bool, str]:
        """Which input shapes this arch runs (DESIGN.md §4 skips)."""
        if shape_name == "long_500k":
            if self.family in ("ssm", "hybrid"):
                return True, "sub-quadratic (SSM/hybrid)"
            if self.window is not None:
                return True, f"sliding-window attention (W={self.window})"
            if self.family in ("dense", "moe"):
                return True, "SWA long-context variant (DESIGN.md §4)"
            return False, ("full-attention VLM/enc-dec arch: quadratic "
                           "attention at 500k; no SWA variant published")
        return True, ""


def param_count_estimate(cfg: ArchConfig) -> int:
    """Rough N for MODEL_FLOPS=6ND accounting (embeddings excluded)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    per_layer = 0
    if cfg.n_heads:
        per_layer += d * hd * (cfg.n_heads + 2 * cfg.n_kv) + cfg.n_heads * hd * d
    if cfg.moe is not None:
        per_layer += 3 * d * cfg.moe.d_ff_expert * cfg.moe.num_experts
        per_layer += d * cfg.moe.num_experts
    elif cfg.d_ff:
        per_layer += 3 * d * cfg.d_ff
    if cfg.ssm is not None:
        di = cfg.ssm.expand * d
        nh = di // cfg.ssm.headdim
        conv_dim = di + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
        per_layer += d * (2 * di + 2 * cfg.ssm.n_groups * cfg.ssm.d_state + nh)
        per_layer += conv_dim * cfg.ssm.conv_width + di * d + nh * 2 + di
    total = cfg.n_layers * per_layer
    total += 2 * cfg.vocab * d  # embed + head
    if cfg.encoder is not None:
        e = cfg.encoder
        total += e.n_layers * (4 * d * d + 3 * d * e.d_ff)
    return int(total)


def active_param_count_estimate(cfg: ArchConfig) -> int:
    """N_active for MoE (6·N_active·D accounting)."""
    if cfg.moe is None:
        return param_count_estimate(cfg)
    d = cfg.d_model
    dense_moe = 3 * d * cfg.moe.d_ff_expert * cfg.moe.num_experts
    active_moe = 3 * d * cfg.moe.d_ff_expert * cfg.moe.top_k
    return param_count_estimate(cfg) - cfg.n_layers * (dense_moe - active_moe)
