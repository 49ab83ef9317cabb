"""The dense decoder's parameter template and attention dims (the JAX
package's ``models/model.py``, the parts the serving engine needs).

``embed`` and ``lm_head`` are separate leaves although the config ties
the embeddings: the JAX template has both, and the leaf order fixes
every tensor id.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ArchConfig
from ..core.zampling import LeafSpec
from .attention import AttnDims


@dataclass(frozen=True)
class Model:
    """What the serving engine needs of a model: its config."""

    cfg: ArchConfig


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family not in ("dense", "vlm") or cfg.moe is not None:
        raise NotImplementedError(
            "the port covers the dense decoder family; got "
            f"family={cfg.family!r}")
    return Model(cfg)


def attn_dims(cfg: ArchConfig) -> AttnDims:
    return AttnDims(
        n_heads=cfg.n_heads,
        n_kv=cfg.n_kv,
        head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm,
        window=cfg.window,
        rope_theta=cfg.rope_theta,
        causal=True,
    )


def param_template(cfg: ArchConfig) -> dict:
    """Nested {name: LeafSpec} of the dense decoder's parameters, with
    the layer stacks' leading (n_layers,) axis."""
    dt = cfg.dtype
    L, D = cfg.n_layers, cfg.d_model
    dims = attn_dims(cfg)
    h, kv, hd = dims.n_heads, dims.n_kv, dims.head_dim
    attn = {
        "wq": LeafSpec((L, D, h * hd), dt),
        "wk": LeafSpec((L, D, kv * hd), dt),
        "wv": LeafSpec((L, D, kv * hd), dt),
        "wo": LeafSpec((L, h * hd, D), dt),
    }
    if dims.qkv_bias:
        attn["bq"] = LeafSpec((L, h * hd), dt)
        attn["bk"] = LeafSpec((L, kv * hd), dt)
        attn["bv"] = LeafSpec((L, kv * hd), dt)
    if dims.qk_norm:
        attn["q_norm"] = LeafSpec((L, hd), dt)
        attn["k_norm"] = LeafSpec((L, hd), dt)
    return {
        "embed": LeafSpec((cfg.padded_vocab, D), dt),
        "blocks": {
            "attn": attn,
            "ln1": LeafSpec((L, D), dt),
            "ln2": LeafSpec((L, D), dt),
            "mlp": {
                "gate": LeafSpec((L, D, cfg.d_ff), dt),
                "up": LeafSpec((L, D, cfg.d_ff), dt),
                "down": LeafSpec((L, cfg.d_ff, D), dt),
            },
        },
        "final_norm": LeafSpec((D,), dt),
        "lm_head": LeafSpec((D, cfg.padded_vocab), dt),
    }
