"""Model assembly (the JAX package's ``models/model.py``): every
family's parameter template, dense-leaf init, the K-client training
forward and loss, and single-model decoding.

Families:
  dense   — GQA + SwiGLU decoder (Yi, Qwen1.5/2/3)
  moe     — GQA + MoE decoder (OLMoE, Mixtral w/ SWA)
  ssm     — Mamba2 SSD stack (attention-free)
  hybrid  — Mamba2 backbone + one SHARED attention block every
            ``attn_every`` layers (Zamba2)
  vlm     — dense decoder consuming stubbed patch/text embeddings (Pixtral)
  encdec  — encoder + cross-attending decoder (Seamless, family
            ``audio``; stubbed audio-frame embeddings feed the encoder)

``embed`` and ``lm_head`` are separate leaves although a config may tie
the embeddings: the JAX template has both, and the leaf order fixes
every tensor id.

``forward``/``loss_fn`` run K clients at once (the JAX package vmaps
one client): every parameter leaf of the flat {path: leaf} dict that
``MaskProgram.weights`` returns carries a leading client axis K,
tokens and labels are (K, B, S), logits (K, B, S, padded_vocab), and
``loss_fn`` returns the (K,) per-client losses, each with its client's
MoE aux loss.  The embedding lookup is a gather per client
(``index_select``, whose backward torch runs deterministically on
request).  The JAX package scans layers with nested remat; here the
layers are a Python loop, and the SSM layers (the only ones whose
activations would crowd the card at full width) each run under
``torch.utils.checkpoint`` when a gradient is wanted: recomputation
changes memory, not values.  Initial parameters come from numpy
(``init_params`` draws from ``jax.random``, which has no torch twin).

Decoding (``Model.init_cache``, ``Model.decode_step``) runs one model
over a flat {path: leaf} dict without the client axis, the caches those
of the JAX package.  The dense decoder decodes in float32 through
``decode_layers``, which the serving engine shares, at any window; the
other families decode in their leaves' dtype, as JAX does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.zampling import LeafSpec, flatten
from . import attention as attn
from .attention import (AttnDims, KVCache, cross_attention,
                        decode_self_attention, encode_kv, self_attention)
from .common import cross_entropy, linear, rms_norm, swiglu
from .moe import moe_block
from .ssm import (SSMCache, SSMDims, init_ssm_cache, ssm_block,
                  ssm_decode_step, ssm_dims, ssm_param_shapes)

FAMILIES = {"dense": "decoder", "moe": "decoder", "vlm": "decoder",
            "ssm": "ssm", "hybrid": "hybrid", "encdec": "encdec",
            "audio": "encdec"}


def family(cfg: ArchConfig) -> str:
    """The model builder a config takes: decoder, ssm, hybrid or encdec."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return FAMILIES[cfg.family]


def _dense_decoder(cfg: ArchConfig) -> bool:
    """The decoder the serving engine runs (no MoE)."""
    return family(cfg) == "decoder" and cfg.moe is None


class HybridCache(NamedTuple):
    ssm: SSMCache  # stacked (L_mamba, ...)
    kv: KVCache  # stacked (n_attn_applications, ...)


class EncDecCache(NamedTuple):
    self_kv: KVCache  # stacked (L_dec, ...)
    cross_k: torch.Tensor  # (L_dec, B, Se, KV, hd)
    cross_v: torch.Tensor


@dataclass(frozen=True)
class Model:
    """A config (and a window override, as the JAX package's
    ``build_model`` takes it): the K-client ``forward``/``loss`` and
    single-model decoding over dense parameters."""

    cfg: ArchConfig
    window_override: Optional[int] = None

    def forward(self, params, batch):
        """(logits, {"aux_loss": (K,)}) of K clients."""
        return forward_with_aux(self.cfg, params, batch,
                                window_override=self.window_override)

    def loss(self, params, batch) -> torch.Tensor:
        return loss_fn(self.cfg, params, batch,
                       window_override=self.window_override)

    def init_cache(self, params, batch_size: int, seq_len: int,
                   device=None):
        """The family's cache at position 0, on ``device``: by default
        where ``params`` live, or the card when there are none
        (``params`` gives nothing else, as in the JAX package).  The
        dense decoder's KV cache is float32 (at the config's own window);
        the other families' caches are in the config's dtype (SSM states
        float32), as in JAX."""
        if device is None:
            leaf = next(iter(params.values()), None) if params else None
            device = leaf.device if torch.is_tensor(leaf) else "cuda"
        cfg = self.cfg
        fam = family(cfg)
        dims = attn_dims(cfg, self.window_override)
        L = cfg.n_layers
        if _dense_decoder(cfg):
            one = attn.init_cache(batch_size, seq_len, dims, torch.float32,
                                  device)
            return _stack_kv(one, L)
        dt = _dtype(cfg)
        if fam == "decoder":
            return _stack_kv(attn.init_cache(batch_size, seq_len, dims, dt,
                                             device), L)
        if fam in ("ssm", "hybrid"):
            one = init_ssm_cache(batch_size, ssm_dims(cfg.d_model, cfg.ssm),
                                 dt, device)
            sc = SSMCache(conv=one.conv[None].repeat(L, 1, 1, 1),
                          state=one.state[None].repeat(L, 1, 1, 1, 1))
            if fam == "ssm":
                return sc
            n_groups, rem = divmod(L, cfg.attn_every)
            return HybridCache(ssm=sc, kv=_stack_kv(attn.init_cache(
                batch_size, seq_len, dims, dt, device), n_groups + bool(rem)))
        enc_len = max(seq_len // 4, 1)
        cross = torch.zeros((L, batch_size, enc_len, dims.n_kv,
                             dims.head_dim), dtype=dt, device=device)
        return EncDecCache(
            self_kv=_stack_kv(attn.init_cache(batch_size, seq_len, dims, dt,
                                              device), L),
            cross_k=cross, cross_v=cross.clone())

    @torch.no_grad()
    def decode_step(self, params: Dict[str, torch.Tensor], cache,
                    batch) -> tuple:
        """One token a row: ``batch["tokens"]`` (B, 1) -> (logits (B, 1,
        padded_vocab), cache), every leaf a dense tensor."""
        cfg = self.cfg
        if _dense_decoder(cfg):
            def linear_fn(path, layer, x2d):
                w = params[path]
                return x2d @ (w[layer] if w.ndim == 3 else w).to(
                    torch.float32)

            x = (batch["embeds"] if "embeds" in batch else
                 params["embed"][batch["tokens"]]).to(torch.float32)
            return decode_layers(cfg, x, cache, linear_fn,
                                 lambda p: params[p].to(torch.float32),
                                 window_override=self.window_override)
        return _DECODERS[family(cfg)](cfg, attn_dims(
            cfg, self.window_override), params, cache, batch)


def build_model(cfg: ArchConfig, *, window_override=None) -> Model:
    family(cfg)
    return Model(cfg, window_override)


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _stack_kv(one: KVCache, n: int) -> KVCache:
    return KVCache(k=one.k[None].repeat(n, 1, 1, 1, 1),
                   v=one.v[None].repeat(n, 1, 1, 1, 1), pos=one.pos)


def attn_dims(cfg: ArchConfig, window_override=None) -> AttnDims:
    return AttnDims(
        n_heads=cfg.n_heads,
        n_kv=cfg.n_kv,
        head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm,
        window=window_override if window_override is not None else cfg.window,
        rope_theta=cfg.rope_theta,
        causal=True,
    )


def enc_attn_dims(cfg: ArchConfig) -> AttnDims:
    """The enc-dec encoder's non-causal attention."""
    ec = cfg.encoder
    return AttnDims(n_heads=ec.n_heads, n_kv=ec.n_kv,
                    head_dim=cfg.d_model // ec.n_heads, causal=False,
                    rope_theta=cfg.rope_theta)


def decode_layers(cfg: ArchConfig, x: torch.Tensor, cache: KVCache,
                  linear_fn: Callable, dense: Callable,
                  live: Optional[torch.Tensor] = None,
                  window_override: Optional[int] = None):
    """The decoder's layers for one token a row, unrolled in Python:
    embedded tokens x (B, 1, D) float32 -> (logits (B, 1, V), cache).

    ``linear_fn(path, layer, x2d)`` is every projection, (B, d_in) ->
    (B, d_out) float32 (the serving engine streams the zampled ones);
    ``dense(path)`` a dense leaf (norms, biases).  A scalar
    ``cache.pos`` is the single-request path, a (B,) one the per-lane
    path with the optional (B,) ``live`` mask."""
    dims = attn_dims(cfg, window_override)
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



# ---------------------------------------------------------------------------
# parameter templates
# ---------------------------------------------------------------------------

def _shp(stack: int, *s) -> tuple:
    return (stack, *s) if stack else tuple(s)


def _attn_template(D: int, dims: AttnDims, dt: str, stack: int) -> dict:
    h, kv, hd = dims.n_heads, dims.n_kv, dims.head_dim
    p = {
        "wq": LeafSpec(_shp(stack, D, h * hd), dt),
        "wk": LeafSpec(_shp(stack, D, kv * hd), dt),
        "wv": LeafSpec(_shp(stack, D, kv * hd), dt),
        "wo": LeafSpec(_shp(stack, h * hd, D), dt),
    }
    if dims.qkv_bias:
        p["bq"] = LeafSpec(_shp(stack, h * hd), dt)
        p["bk"] = LeafSpec(_shp(stack, kv * hd), dt)
        p["bv"] = LeafSpec(_shp(stack, kv * hd), dt)
    if dims.qk_norm:
        p["q_norm"] = LeafSpec(_shp(stack, hd), dt)
        p["k_norm"] = LeafSpec(_shp(stack, hd), dt)
    return p


def _mlp_template(D: int, F_: int, dt: str, stack: int) -> dict:
    return {"gate": LeafSpec(_shp(stack, D, F_), dt),
            "up": LeafSpec(_shp(stack, D, F_), dt),
            "down": LeafSpec(_shp(stack, F_, D), dt)}


def _decoder_block_template(cfg: ArchConfig, stack: int) -> dict:
    """The JAX package's ``_init_decoder_block``: ``moe`` replaces
    ``mlp`` (router float32 (L, D, E); experts (L, E, D, F), (L, E, F,
    D)); ``stack`` 0 gives the hybrid's unstacked shared block."""
    dt, D = cfg.dtype, cfg.d_model
    p = {"attn": _attn_template(D, attn_dims(cfg), dt, stack),
         "ln1": LeafSpec(_shp(stack, D), dt),
         "ln2": LeafSpec(_shp(stack, D), dt)}
    if cfg.moe is not None:
        E, F_ = cfg.moe.num_experts, cfg.moe.d_ff_expert
        p["moe"] = {"router": LeafSpec(_shp(stack, D, E), "float32"),
                    "gate": LeafSpec(_shp(stack, E, D, F_), dt),
                    "up": LeafSpec(_shp(stack, E, D, F_), dt),
                    "down": LeafSpec(_shp(stack, E, F_, D), dt)}
    else:
        p["mlp"] = _mlp_template(D, cfg.d_ff, dt, stack)
    return p


def _ssm_stack_template(cfg: ArchConfig) -> dict:
    """L stacked mamba blocks and their pre-norms: ``A_log``, ``D`` and
    ``dt_bias`` float32 whatever the config's dtype."""
    sd = ssm_dims(cfg.d_model, cfg.ssm)
    return {"ssm": {name: LeafSpec(shape, "float32" if f32 else cfg.dtype)
                    for name, (shape, f32)
                    in ssm_param_shapes(sd, cfg.n_layers).items()},
            "ln": LeafSpec((cfg.n_layers, cfg.d_model), cfg.dtype)}


def param_template(cfg: ArchConfig) -> dict:
    """Nested {name: LeafSpec} of the family's parameters, the JAX
    package's ``init_params`` tree (paths, shapes, dtypes), layer
    stacks with their leading layer axis."""
    dt, L, D = cfg.dtype, cfg.n_layers, cfg.d_model
    V = cfg.padded_vocab
    fam = family(cfg)
    tail = {"final_norm": LeafSpec((D,), dt), "lm_head": LeafSpec((D, V), dt)}
    if fam == "decoder":
        return {"embed": LeafSpec((V, D), dt),
                "blocks": _decoder_block_template(cfg, L), **tail}
    if fam == "ssm":
        return {"embed": LeafSpec((V, D), dt),
                "blocks": _ssm_stack_template(cfg), **tail}
    if fam == "hybrid":
        return {"embed": LeafSpec((V, D), dt),
                "mamba": _ssm_stack_template(cfg),
                "shared_attn": _decoder_block_template(cfg, 0), **tail}
    ec = cfg.encoder
    Le = ec.n_layers
    dec = _decoder_block_template(cfg, L)
    dec["cross"] = _attn_template(D, attn_dims(cfg), dt, L)
    dec["ln3"] = LeafSpec((L, D), dt)
    return {
        "enc_blocks": {"attn": _attn_template(D, enc_attn_dims(cfg), dt, Le),
                       "ln1": LeafSpec((Le, D), dt),
                       "ln2": LeafSpec((Le, D), dt),
                       "mlp": _mlp_template(D, ec.d_ff, dt, Le)},
        "enc_norm": LeafSpec((D,), dt),
        "dec_embed": LeafSpec((V, D), dt),
        "dec_blocks": dec,
        **tail,
    }


_ONES = ("ln", "ln1", "ln2", "ln3", "final_norm", "enc_norm", "q_norm",
         "k_norm", "norm", "D")
_ZEROS = ("bq", "bk", "bv", "conv_b")


def init_dense(cfg: ArchConfig, paths, seed: int = 0) -> Dict[str, np.ndarray]:
    """f32 numpy values of the given (dense) leaves by the JAX package's
    ``init_params`` rules: norms and the SSM skip ``D`` ones, QKV biases
    and ``conv_b`` zeros, embeddings N(0, 1/d_model), ``conv_w`` N(0,
    1/conv_width), ``A_log`` = log U(1, 16), ``dt_bias`` = log(expm1(
    exp(U(log 1e-3, log 1e-1)))), every other weight (the router and the
    experts too) He-normal N(0, 2/fan_in) with fan_in = shape[-2]; drawn
    from ``RandomState(seed)`` in the order of ``paths`` (``init_params``
    draws from ``jax.random``, which has no twin)."""
    tmpl = dict(flatten(param_template(cfg)))
    rng = np.random.RandomState(seed)
    out = {}
    for path in paths:
        shape = tmpl[path].shape
        name = path.rsplit("/", 1)[-1]
        if name in _ONES:
            out[path] = np.ones(shape, np.float32)
        elif name in _ZEROS:
            out[path] = np.zeros(shape, np.float32)
        elif name == "A_log":
            out[path] = np.log(rng.uniform(1.0, 16.0, shape)).astype(
                np.float32)
        elif name == "dt_bias":
            u = rng.uniform(np.log(1e-3), np.log(1e-1), shape)
            out[path] = np.log(np.expm1(np.exp(u))).astype(np.float32)
        else:
            std = (cfg.d_model ** -0.5 if name in ("embed", "dec_embed")
                   else cfg.ssm.conv_width ** -0.5 if name == "conv_w"
                   else (2.0 / shape[-2]) ** 0.5)
            out[path] = (rng.randn(*shape) * std).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# the K-client training forward
# ---------------------------------------------------------------------------

def _sub(tree: Dict[str, torch.Tensor], prefix: str) -> dict:
    return {p[len(prefix):]: v for p, v in tree.items()
            if p.startswith(prefix)}


def _unstack(params, prefix: str) -> dict:
    """{path under ``prefix``: the L per-layer (K, ...) slices}: one
    unbind per stacked leaf, whose backward stacks the L layers'
    gradients once, where a slice per layer would add L full-size
    zero-padded gradients into the leaf."""
    return {p: v.unbind(1) for p, v in _sub(params, prefix).items()}


def _layer(stacks: dict, layer: int) -> dict:
    return {p: v[layer] for p, v in stacks.items()}


def _embed(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """K clients' lookups: emb (K, V, D), tokens (K, B, S) -> (K, B, S,
    D)."""
    K = tokens.shape[0]
    return torch.stack([torch.index_select(emb[k], 0, tokens[k].reshape(-1))
                        for k in range(K)]).reshape(*tokens.shape, -1)


def _norm(x, scale):
    """RMSNorm by a (K, D) scale, one row a client."""
    return rms_norm(x, scale[:, None, None])


def _decoder_block(bp, x, cfg: ArchConfig, dims: AttnDims, positions):
    """One layer (or the hybrid's shared block): ``bp`` {path under the
    block: (K, ...) leaf}.  Returns (x, (K,) aux loss or None)."""
    x = x + self_attention(_sub(bp, "attn/"), _norm(x, bp["ln1"]), dims,
                           positions)
    if cfg.moe is not None:
        mo, aux = moe_block(_sub(bp, "moe/"), _norm(x, bp["ln2"]), cfg.moe)
        return x + mo, aux
    return x + swiglu(_norm(x, bp["ln2"]), bp["mlp/gate"], bp["mlp/up"],
                      bp["mlp/down"]), None


def _ssm_layer(bp, x, sdims: SSMDims):
    return x + ssm_block(_sub(bp, "ssm/"), _norm(x, bp["ln"]), sdims)


def _ssm_layer_remat(bp, x, sdims: SSMDims):
    """An SSM layer, recomputed in the backward pass when a gradient is
    wanted (the JAX package's per-layer remat)."""
    if not torch.is_grad_enabled():
        return _ssm_layer(bp, x, sdims)
    return checkpoint(lambda x_, *vals: _ssm_layer(dict(zip(bp, vals)), x_,
                                                   sdims),
                      x, *bp.values(), use_reentrant=False)


def _encode(cfg: ArchConfig, params, enc_embeds: torch.Tensor):
    x = enc_embeds.to(_dtype(cfg))
    K, B, Se, _ = x.shape
    dims = enc_attn_dims(cfg)
    positions = torch.arange(Se, device=x.device).expand(B, Se)
    stacks = _unstack(params, "enc_blocks/")
    for layer in range(cfg.encoder.n_layers):
        bp = _layer(stacks, layer)
        x = x + self_attention(_sub(bp, "attn/"), _norm(x, bp["ln1"]), dims,
                               positions)
        x = x + swiglu(_norm(x, bp["ln2"]), bp["mlp/gate"], bp["mlp/up"],
                       bp["mlp/down"])
    return _norm(x, params["enc_norm"])


def forward_with_aux(cfg: ArchConfig, params: Dict[str, torch.Tensor], batch,
                     *, window_override=None):
    """(logits (K, B, S, padded_vocab), {"aux_loss": (K,)}) of K clients'
    models.  ``batch``: {"tokens": (K, B, S)} (a tensor is taken for
    the tokens), with ``embeds`` (K, B, S, D) for a VLM's stubbed
    embeddings and ``enc_embeds`` (K, B, Se, D) for the enc-dec
    encoder."""
    if torch.is_tensor(batch):
        batch = {"tokens": batch}
    fam = family(cfg)
    dims = attn_dims(cfg, window_override)
    K = params["lm_head"].shape[0]
    dev = params["lm_head"].device
    aux = torch.zeros((K,), dtype=torch.float32, device=dev)
    tokens = batch.get("tokens")
    if tokens is not None:
        tokens = tokens.to(torch.int64)
    if fam == "decoder":
        x = (batch["embeds"].to(_dtype(cfg)) if "embeds" in batch
             else _embed(params["embed"], tokens))
    elif fam == "encdec":
        enc_out = _encode(cfg, params, batch["enc_embeds"])
        x = _embed(params["dec_embed"], tokens)
    else:
        x = _embed(params["embed"], tokens)
    _, B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)

    if fam == "decoder":
        stacks = _unstack(params, "blocks/")
        for layer in range(cfg.n_layers):
            x, a = _decoder_block(_layer(stacks, layer), x, cfg, dims,
                                  positions)
            if a is not None:
                aux = aux + a
    elif fam == "ssm":
        sdims = ssm_dims(cfg.d_model, cfg.ssm)
        stacks = _unstack(params, "blocks/")
        for layer in range(cfg.n_layers):
            x = _ssm_layer_remat(_layer(stacks, layer), x, sdims)
    elif fam == "hybrid":
        sdims = ssm_dims(cfg.d_model, cfg.ssm)
        stacks = _unstack(params, "mamba/")
        shared = _sub(params, "shared_attn/")
        for layer in range(cfg.n_layers):
            # the shared block before every attn_every group and the rest
            if layer % cfg.attn_every == 0:
                x, _ = _decoder_block(shared, x, cfg, dims, positions)
            x = _ssm_layer_remat(_layer(stacks, layer), x, sdims)
    else:
        stacks = _unstack(params, "dec_blocks/")
        for layer in range(cfg.n_layers):
            bp = _layer(stacks, layer)
            x = x + self_attention(_sub(bp, "attn/"), _norm(x, bp["ln1"]),
                                   dims, positions)
            ek, ev = encode_kv(_sub(bp, "cross/"), enc_out, dims)
            x = x + cross_attention(_sub(bp, "cross/"), _norm(x, bp["ln3"]),
                                    ek, ev, dims)
            x = x + swiglu(_norm(x, bp["ln2"]), bp["mlp/gate"], bp["mlp/up"],
                           bp["mlp/down"])
    x = _norm(x, params["final_norm"])
    return linear(x, params["lm_head"]), {"aux_loss": aux}


def forward(cfg: ArchConfig, params: Dict[str, torch.Tensor], batch, *,
            window_override=None) -> torch.Tensor:
    """Logits (K, B, S, padded_vocab) of K clients' models on their
    tokens (K, B, S) or batch (``forward_with_aux``)."""
    return forward_with_aux(cfg, params, batch,
                            window_override=window_override)[0]


def loss_fn(cfg: ArchConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], *,
            window_override=None) -> torch.Tensor:
    """(K,) next-token cross-entropy (logits at positions [0, S-1)
    against labels at [1, S), vocabulary padding masked out) plus each
    client's MoE aux loss."""
    logits, aux = forward_with_aux(cfg, params, batch,
                                   window_override=window_override)
    labels = batch["labels"].to(torch.int64)
    return cross_entropy(logits[:, :, :-1], labels[:, :, 1:],
                         num_classes=cfg.vocab, lead=1) + aux["aux_loss"]


# ---------------------------------------------------------------------------
# single-model decoding (no client axis), the families but the dense one
# (the MoE decoder, the SSM, the hybrid and the enc-dec)
# ---------------------------------------------------------------------------

def _k1(tree: dict) -> dict:
    """Leaves of one model as K=1 clients."""
    return {p: v[None] for p, v in tree.items()}


def _decoder_block_decode(bp, x, cache: KVCache, cfg: ArchConfig,
                          dims: AttnDims):
    h, cache = decode_self_attention(_sub(bp, "attn/"),
                                     rms_norm(x, bp["ln1"]), cache, dims)
    x = x + h
    if cfg.moe is not None:
        mo, _ = moe_block(_k1(_sub(bp, "moe/")), rms_norm(x, bp["ln2"])[None],
                          cfg.moe)
        return x + mo[0], cache
    return x + swiglu(rms_norm(x, bp["ln2"]), bp["mlp/gate"], bp["mlp/up"],
                      bp["mlp/down"]), cache


def _ssm_layer_decode(bp, x, conv, state, sdims: SSMDims):
    h, nc = ssm_decode_step(_k1(_sub(bp, "ssm/")),
                            rms_norm(x, bp["ln"])[None],
                            SSMCache(conv[None], state[None]), sdims)
    return x + h[0], nc.conv[0], nc.state[0]


def _logits(params, x):
    return rms_norm(x, params["final_norm"]) @ params["lm_head"]


def _decode_decoder(cfg, dims, params, cache: KVCache, batch):
    x = (batch["embeds"] if "embeds" in batch
         else params["embed"][batch["tokens"]])
    blocks = _sub(params, "blocks/")
    nk, nv = [], []
    for layer in range(cfg.n_layers):
        x, nc = _decoder_block_decode(
            _layer(blocks, layer), x,
            KVCache(cache.k[layer], cache.v[layer], cache.pos), cfg, dims)
        nk.append(nc.k)
        nv.append(nc.v)
    return _logits(params, x), KVCache(torch.stack(nk), torch.stack(nv),
                                       cache.pos + 1)


def _decode_ssm(cfg, dims, params, cache: SSMCache, batch):
    sdims = ssm_dims(cfg.d_model, cfg.ssm)
    x = params["embed"][batch["tokens"]]
    blocks = _sub(params, "blocks/")
    convs, states = [], []
    for layer in range(cfg.n_layers):
        x, c, s = _ssm_layer_decode(_layer(blocks, layer), x,
                                    cache.conv[layer], cache.state[layer],
                                    sdims)
        convs.append(c)
        states.append(s)
    return _logits(params, x), SSMCache(torch.stack(convs),
                                        torch.stack(states))


def _decode_hybrid(cfg, dims, params, cache: HybridCache, batch):
    sdims = ssm_dims(cfg.d_model, cfg.ssm)
    x = params["embed"][batch["tokens"]]
    shared = _sub(params, "shared_attn/")
    mamba = _sub(params, "mamba/")
    convs, states, nk, nv = [], [], [], []
    for layer in range(cfg.n_layers):
        if layer % cfg.attn_every == 0:
            a = layer // cfg.attn_every
            x, nc = _decoder_block_decode(
                shared, x, KVCache(cache.kv.k[a], cache.kv.v[a],
                                   cache.kv.pos), cfg, dims)
            nk.append(nc.k)
            nv.append(nc.v)
        x, c, s = _ssm_layer_decode(_layer(mamba, layer), x,
                                    cache.ssm.conv[layer],
                                    cache.ssm.state[layer], sdims)
        convs.append(c)
        states.append(s)
    return _logits(params, x), HybridCache(
        ssm=SSMCache(torch.stack(convs), torch.stack(states)),
        kv=KVCache(torch.stack(nk), torch.stack(nv), cache.kv.pos + 1))


def _decode_encdec(cfg, dims, params, cache: EncDecCache, batch):
    x = params["dec_embed"][batch["tokens"]]
    blocks = _sub(params, "dec_blocks/")
    nk, nv = [], []
    for layer in range(cfg.n_layers):
        bp = _layer(blocks, layer)
        h, nc = decode_self_attention(
            _sub(bp, "attn/"), rms_norm(x, bp["ln1"]),
            KVCache(cache.self_kv.k[layer], cache.self_kv.v[layer],
                    cache.self_kv.pos), dims)
        x = x + h
        x = x + cross_attention(_k1(_sub(bp, "cross/")),
                                rms_norm(x, bp["ln3"])[None],
                                cache.cross_k[layer][None],
                                cache.cross_v[layer][None], dims)[0]
        x = x + swiglu(rms_norm(x, bp["ln2"]), bp["mlp/gate"], bp["mlp/up"],
                       bp["mlp/down"])
        nk.append(nc.k)
        nv.append(nc.v)
    return _logits(params, x), EncDecCache(
        self_kv=KVCache(torch.stack(nk), torch.stack(nv),
                        cache.self_kv.pos + 1),
        cross_k=cache.cross_k, cross_v=cache.cross_v)


_DECODERS = {"decoder": _decode_decoder, "ssm": _decode_ssm,
             "hybrid": _decode_hybrid, "encdec": _decode_encdec}
