"""The dense decoder (the JAX package's ``models/model.py``): its
parameter template and attention dims, which the serving engine needs,
and the training forward and loss.

``embed`` and ``lm_head`` are separate leaves although the config ties
the embeddings: the JAX template has both, and the leaf order fixes
every tensor id.

``forward``/``loss_fn`` run K clients at once (the JAX package vmaps
one client): every parameter leaf of the flat {path: leaf} dict that
``MaskProgram.weights`` returns carries a leading client axis K,
tokens and labels are (K, B, S), logits (K, B, S, padded_vocab), and
``loss_fn`` returns the (K,) per-client losses.  The embedding lookup
is a gather per client (``index_select``, whose backward torch runs
deterministically on request).  Initial parameters come from numpy
(``init_params`` draws from ``jax.random``, which has no torch twin).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.zampling import LeafSpec, flatten
from .attention import AttnDims, self_attention
from .common import cross_entropy, linear, rms_norm, swiglu


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


def _decoder_block(bp, x, dims: AttnDims, positions):
    """One layer: ``bp`` {path under ``blocks/``: (K, ...) leaf}."""
    attn = {p[len("attn/"):]: v for p, v in bp.items()
            if p.startswith("attn/")}
    x = x + self_attention(attn, rms_norm(x, bp["ln1"][:, None, None]),
                           dims, positions)
    return x + swiglu(rms_norm(x, bp["ln2"][:, None, None]), bp["mlp/gate"],
                      bp["mlp/up"], bp["mlp/down"])


def forward(cfg: ArchConfig, params: Dict[str, torch.Tensor],
            tokens: torch.Tensor) -> torch.Tensor:
    """Logits (K, B, S, padded_vocab) of K clients' decoders on their
    tokens (K, B, S)."""
    build_model(cfg)
    K, B, S = tokens.shape
    dims = attn_dims(cfg)
    emb = params["embed"]
    x = torch.stack([torch.index_select(emb[k], 0, tokens[k].reshape(-1))
                     for k in range(K)]).reshape(K, B, S, -1)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    # one unbind per stacked leaf: its backward stacks the L layers'
    # gradients once, where a slice per layer would add L full-size
    # zero-padded gradients into the leaf
    blocks = {p[len("blocks/"):]: v.unbind(1) for p, v in params.items()
              if p.startswith("blocks/")}
    for layer in range(cfg.n_layers):
        x = _decoder_block({p: v[layer] for p, v in blocks.items()}, x,
                           dims, positions)
    x = rms_norm(x, params["final_norm"][:, None, None])
    return linear(x, params["lm_head"])


def loss_fn(cfg: ArchConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(K,) next-token cross-entropy: logits at positions [0, S-1)
    against labels at [1, S), vocabulary padding masked out."""
    logits = forward(cfg, params, batch["tokens"].to(torch.int64))
    labels = batch["labels"].to(torch.int64)
    return cross_entropy(logits[:, :, :-1], labels[:, :, 1:],
                         num_classes=cfg.vocab, lead=1)


def init_dense(cfg: ArchConfig, paths, seed: int = 0) -> Dict[str, np.ndarray]:
    """f32 numpy values of the given (dense) leaves as the JAX package's
    ``init_params`` lays them out: norms ones, QKV biases zeros, the
    embedding N(0, 1/d_model), other weights He-normal N(0, 2/fan_in),
    drawn from ``RandomState(seed)`` in the order of ``paths``
    (``init_params`` draws from ``jax.random``, which has no twin)."""
    tmpl = dict(flatten(param_template(cfg)))
    rng = np.random.RandomState(seed)
    out = {}
    for path in paths:
        shape = tmpl[path].shape
        name = path.rsplit("/", 1)[-1]
        if name in ("ln1", "ln2", "final_norm", "q_norm", "k_norm"):
            out[path] = np.ones(shape, np.float32)
        elif name in ("bq", "bk", "bv"):
            out[path] = np.zeros(shape, np.float32)
        else:
            std = (cfg.d_model ** -0.5 if name == "embed"
                   else (2.0 / shape[-2]) ** 0.5)
            out[path] = (rng.randn(*shape) * std).astype(np.float32)
    return out
