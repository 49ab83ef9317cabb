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
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.zampling import LeafSpec, flatten
from . import attention as attn
from .attention import AttnDims, KVCache, self_attention
from .common import cross_entropy, linear, rms_norm, swiglu


@dataclass(frozen=True)
class Model:
    """The dense decoder: its config, and single-token decoding over
    dense parameters (a flat {path: leaf} dict, as
    ``core.zampling.weights_from_masks`` returns it), in float32."""

    cfg: ArchConfig

    def init_cache(self, params, batch_size: int, seq_len: int,
                   device=None) -> KVCache:
        """The (L, B, C, n_kv, hd) float32 KV cache at position 0, on
        ``device``: by default where ``params`` live, or the card when
        there are none (``params`` gives nothing else, as in the JAX
        package)."""
        if device is None:
            leaf = next(iter(params.values()), None) if params else None
            device = leaf.device if torch.is_tensor(leaf) else "cuda"
        dims = attn_dims(self.cfg)
        one = attn.init_cache(batch_size, seq_len, dims, torch.float32,
                              device)
        L = self.cfg.n_layers
        return KVCache(k=one.k[None].repeat(L, 1, 1, 1, 1),
                       v=one.v[None].repeat(L, 1, 1, 1, 1), pos=one.pos)

    @torch.no_grad()
    def decode_step(self, params: Dict[str, torch.Tensor], cache: KVCache,
                    batch) -> tuple:
        """One token a row: ``batch["tokens"]`` (B, 1) -> (logits (B, 1,
        padded_vocab), cache), every leaf a dense tensor."""

        def linear_fn(path, layer, x2d):
            w = params[path]
            return x2d @ (w[layer] if w.ndim == 3 else w).to(torch.float32)

        x = params["embed"].to(torch.float32)[batch["tokens"]]
        return decode_layers(self.cfg, x, cache, linear_fn,
                             lambda p: params[p].to(torch.float32))


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


def decode_layers(cfg: ArchConfig, x: torch.Tensor, cache: KVCache,
                  linear_fn: Callable, dense: Callable,
                  live: Optional[torch.Tensor] = None):
    """The decoder's layers for one token a row, unrolled in Python:
    embedded tokens x (B, 1, D) float32 -> (logits (B, 1, V), cache).

    ``linear_fn(path, layer, x2d)`` is every projection, (B, d_in) ->
    (B, d_out) float32 (the serving engine streams the zampled ones);
    ``dense(path)`` a dense leaf (norms, biases).  A scalar
    ``cache.pos`` is the single-request path, a (B,) one the per-lane
    path with the optional (B,) ``live`` mask."""
    dims = attn_dims(cfg)
    B = x.shape[0]
    lanes = cache.pos.ndim == 1
    if lanes:
        lv = (torch.ones((B,), dtype=torch.bool, device=x.device)
              if live is None else live.to(torch.bool))
        positions = cache.pos[:, None]
    else:
        positions = cache.pos.expand(B, 1)
    extras = (["bq", "bk", "bv"] if dims.qkv_bias else []) + (
        ["q_norm", "k_norm"] if dims.qk_norm else [])
    nk, nv = [], []
    new_pos = cache.pos
    for l in range(cfg.n_layers):
        h = rms_norm(x, dense("blocks/ln1")[l]).reshape(B, -1)
        q = linear_fn("blocks/attn/wq", l, h)[:, None, :]
        k = linear_fn("blocks/attn/wk", l, h)[:, None, :]
        v = linear_fn("blocks/attn/wv", l, h)[:, None, :]
        ap = {e: dense(f"blocks/attn/{e}")[l] for e in extras}
        q, k, v = attn.finish_qkv(ap, q, k, v, dims, positions)
        lc = KVCache(k=cache.k[l], v=cache.v[l], pos=cache.pos)
        if lanes:
            out, nc = attn.decode_attend_lanes(q, k, v, lc, dims, lv)
        else:
            out, nc = attn.decode_attend(q, k, v, lc, dims)
        new_pos = nc.pos
        x = x + linear_fn("blocks/attn/wo", l, out.reshape(B, -1))[:, None, :]
        hm = rms_norm(x, dense("blocks/ln2")[l]).reshape(B, -1)
        g = linear_fn("blocks/mlp/gate", l, hm)
        u = linear_fn("blocks/mlp/up", l, hm)
        x = x + linear_fn("blocks/mlp/down", l, F.silu(g) * u)[:, None, :]
        nk.append(nc.k)
        nv.append(nc.v)
    x = rms_norm(x, dense("final_norm"))
    logits = linear_fn("lm_head", 0, x.reshape(B, -1))[:, None, :]
    return logits, KVCache(k=torch.stack(nk), v=torch.stack(nv), pos=new_pos)


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
