"""Serving engine and generation driver (the JAX package's
``serve/decode.py``, ``mode="streaming"``).

Every zampled linear of the decode step contracts the activations
against the encoded words through ``kernels.ops.serve_matmul`` (or
``serve_matvec`` for a single request), so no weight tensor exists.
Layers run in a Python loop, as in JAX, where they are unrolled.

Activations and the KV cache are float32.  The streamed projections
return float32; the JAX engine writes them into the config's cache
dtype with a one-hot blend, which under ``jax.jit`` turns a bf16 cache
into float32 after the first step.  The port keeps the cache float32
from the start, which is what the JAX scheduler computes.

``mode="load"`` and ``mode="cached"`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels import ops
from ..models import attention as attn
from ..models.attention import KVCache
from ..models.common import rms_norm
from ..models.model import Model, attn_dims
from .state import ServeState

_LATER_MODES = {
    "load": "reconstruct-on-load serving comes with the load/cached slice "
            "(kernel qz_sample_reconstruct_fwd)",
    "cached": "the hot-block tile cache comes with the load/cached slice",
}
_DENSE_ONLY = ("ln1", "ln2", "bq", "bk", "bv", "q_norm", "k_norm",
               "final_norm")


def check_mode(mode: str) -> None:
    if mode in _LATER_MODES:
        raise NotImplementedError(f"mode={mode!r} is not ported yet: "
                                  f"{_LATER_MODES[mode]}")
    if mode != "streaming":
        raise ValueError(f"unknown serve mode {mode!r}")


def make_generator(step_fn, max_new_tokens: int):
    """Greedy generation driver over ``step_fn(arrays, cache, tok)``.

    Returns ``run(arrays, cache, prompt) -> (new_tokens (B, N), cache)``:
    the prompt goes through the step token by token (building the KV
    cache), then ``max_new_tokens`` are chosen by argmax.  (The JAX
    driver's temperature sampling draws from ``jax.random`` and is not
    ported.)
    """

    @torch.no_grad()
    def run(arrays, cache, prompt):
        logits = None
        for t in range(prompt.shape[1]):
            logits, cache = step_fn(arrays, cache, prompt[:, t:t + 1])
        toks = [torch.argmax(logits[:, -1], dim=-1)]
        for _ in range(1, max_new_tokens):
            logits, cache = step_fn(arrays, cache, toks[-1][:, None])
            toks.append(torch.argmax(logits[:, -1], dim=-1))
        return torch.stack(toks, dim=1), cache

    return run


class ServeEngine(NamedTuple):
    """A serving plan for one (model, ServeState) pair.

    ``step(arrays, cache, tok (B, 1), live=None) -> (logits (B, 1, V),
    cache)``: a scalar ``cache.pos`` is the single-request path, a (B,)
    one the per-lane path with an optional (B,) ``live`` mask.
    """

    step: Callable[..., Any]
    arrays_of: Callable[..., Dict[str, Any]]
    init_cache: Callable[[int, int], Any]
    init_lane_cache: Callable[[int, int], Any]
    mode: str


def build_serve_engine(model: Model, sstate: ServeState, *,
                       mode: str = "streaming", impl: Optional[str] = None,
                       device="cuda") -> ServeEngine:
    """Build the streaming decode step for a dense-family decoder.

    ``impl`` picks the serve impl (``"cuda"`` or ``"chunked"``; default
    by the tensors' device).  ``sstate`` must live on ``device``.
    """
    check_mode(mode)
    dev = resolve_device(device)
    if sstate.device.type != dev.type:
        raise ValueError(f"serve state lives on {sstate.device}, engine "
                         f"asked for {dev}")
    cfg = model.cfg
    dims = attn_dims(cfg)
    L = cfg.n_layers
    specs = sstate.zspecs.specs
    qbits = sstate.qbits
    for path in specs:
        if path.rsplit("/", 1)[-1] in _DENSE_ONLY:
            raise NotImplementedError(
                f"engine expects bias/norm leaves dense, got zampled {path!r}")

    def arrays_of(s: ServeState) -> Dict[str, Any]:
        return s.arrays()

    def linear(arrays, path, layer, x2d):
        """x2d (B, d_in) @ leaf[layer] -> (B, d_out) float32."""
        spec = specs.get(path)
        if spec is None:
            w = arrays["dense"][path]
            return x2d @ (w[layer] if w.ndim == 3 else w)
        words, step = arrays["words"][path], arrays["step"]
        if x2d.shape[0] == 1:
            return ops.serve_matvec(spec, words, step, x2d[0], group=layer,
                                    qbits=qbits, impl=impl)[None]
        return ops.serve_matmul(spec, words, step, x2d, group=layer,
                                qbits=qbits, impl=impl)

    def embed_rows(arrays, tokens):
        spec = specs.get("embed")
        if spec is None:
            return arrays["dense"]["embed"][tokens]
        return ops.serve_embed_rows(spec, arrays["words"]["embed"],
                                    arrays["step"], tokens, qbits=qbits)

    extras = (["bq", "bk", "bv"] if dims.qkv_bias else []) + (
        ["q_norm", "k_norm"] if dims.qk_norm else [])

    @torch.no_grad()
    def step(arrays, cache: KVCache, tokens, live=None):
        dense = arrays["dense"]
        x = embed_rows(arrays, tokens)  # (B, 1, D)
        B = x.shape[0]
        lanes = cache.pos.ndim == 1
        if lanes:
            lv = (torch.ones((B,), dtype=torch.bool, device=x.device)
                  if live is None else live.to(torch.bool))
            positions = cache.pos[:, None]
        else:
            positions = cache.pos.expand(B, 1)
        nk, nv = [], []
        new_pos = cache.pos
        for l in range(L):
            h = rms_norm(x, dense["blocks/ln1"][l]).reshape(B, -1)
            q = linear(arrays, "blocks/attn/wq", l, h)[:, None, :]
            k = linear(arrays, "blocks/attn/wk", l, h)[:, None, :]
            v = linear(arrays, "blocks/attn/wv", l, h)[:, None, :]
            ap = {e: dense[f"blocks/attn/{e}"][l] for e in extras}
            q, k, v = attn.finish_qkv(ap, q, k, v, dims, positions)
            lc = KVCache(k=cache.k[l], v=cache.v[l], pos=cache.pos)
            if lanes:
                out, nc = attn.decode_attend_lanes(q, k, v, lc, dims, lv)
            else:
                out, nc = attn.decode_attend(q, k, v, lc, dims)
            new_pos = nc.pos
            x = x + linear(arrays, "blocks/attn/wo", l,
                           out.reshape(B, -1))[:, None, :]
            hm = rms_norm(x, dense["blocks/ln2"][l]).reshape(B, -1)
            g = linear(arrays, "blocks/mlp/gate", l, hm)
            u = linear(arrays, "blocks/mlp/up", l, hm)
            x = x + linear(arrays, "blocks/mlp/down", l,
                           F.silu(g) * u)[:, None, :]
            nk.append(nc.k)
            nv.append(nc.v)
        x = rms_norm(x, dense["final_norm"])
        logits = linear(arrays, "lm_head", 0, x.reshape(B, -1))[:, None, :]
        return logits, KVCache(k=torch.stack(nk), v=torch.stack(nv),
                               pos=new_pos)

    def init_cache(batch_size: int, seq_len: int) -> KVCache:
        one = attn.init_cache(batch_size, seq_len, dims, torch.float32, dev)
        return KVCache(k=one.k[None].repeat(L, 1, 1, 1, 1),
                       v=one.v[None].repeat(L, 1, 1, 1, 1), pos=one.pos)

    def init_lane_cache(lanes: int, seq_len: int) -> KVCache:
        c = init_cache(lanes, seq_len)
        return c._replace(pos=torch.zeros((lanes,), dtype=torch.int64,
                                          device=dev))

    return ServeEngine(step=step, arrays_of=arrays_of, init_cache=init_cache,
                       init_lane_cache=init_lane_cache, mode=mode)


def serve_generate(model: Model, sstate: ServeState, prompt, max_new_tokens: int,
                   *, mode: str = "streaming", impl: Optional[str] = None,
                   seq_len: Optional[int] = None,
                   device="cuda") -> torch.Tensor:
    """Greedy generation from a ServeState; (B, Sp+new) int64 tokens."""
    engine = build_serve_engine(model, sstate, mode=mode, impl=impl,
                                device=device)
    prompt = torch.as_tensor(prompt, dtype=torch.int64,
                             device=resolve_device(device))
    B, Sp = prompt.shape
    kv = engine.init_cache(B, seq_len or (Sp + max_new_tokens))
    run = make_generator(engine.step, max_new_tokens)
    new, _ = run(engine.arrays_of(sstate), kv, prompt)
    return torch.cat([prompt, new], dim=1)
