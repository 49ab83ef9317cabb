"""Serving engine and generation driver (the JAX package's
``serve/decode.py``).

Three ways to source a zampled linear's weights at decode time, one
engine and one canonical contraction:

- ``mode="load"``: every zampled leaf reconstructed once
  (``serve.state.reconstruct_resident``, kernel 7 on the card) and read
  by ``ops.serve_resident_matmul``: fast, but 32 bits a weight.
- ``mode="streaming"``: the node holds only the encoded words; every
  linear calls ``ops.serve_matmul`` (``serve_matvec`` at B=1), which
  regenerates the weights inside the contraction.  No weight tensor
  exists.
- ``mode="cached"``: streaming plus the hot-block tile pool
  (``serve.cache``): a block with a slot reads its weights from the
  pool, the others regenerate them (``ops.serve_cached_matmul``).

All three walk the canonical tree with the same weight values, so they
give the same logits bit for bit at any cache occupancy; on the card
they are one kernel with three weight sources.  Layers run in a Python
loop (``models.model.decode_layers``), as in JAX, where they are
unrolled.

Activations and the KV cache are float32.  The streamed projections
return float32; the JAX engine writes them into the config's cache
dtype with a one-hot blend, which under ``jax.jit`` turns a bf16 cache
into float32 after the first step.  The port keeps the cache float32
from the start, which is what the JAX scheduler computes.

Sampling is greedy: the JAX package's temperature sampling draws from
``jax.random``, which has no torch twin.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ..core.zampling import ZamplingSpecs, weights_from_masks
from ..device import resolve_device
from ..kernels import ops
from ..models.attention import KVCache
from ..models.model import Model, decode_layers
from .state import ServeState, reconstruct_resident

MODES = ("load", "streaming", "cached")
_DENSE_ONLY = ("ln1", "ln2", "bq", "bk", "bv", "q_norm", "k_norm",
               "final_norm")


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown serve mode {mode!r}")


def make_generator(step_fn, max_new_tokens: int):
    """Greedy generation driver over ``step_fn(arrays, cache, tok)``.

    Returns ``run(arrays, cache, prompt) -> (new_tokens (B, N), cache)``:
    the prompt goes through the step token by token (building the KV
    cache), then ``max_new_tokens`` are chosen by argmax.
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


def generate(model: Model, params: Dict[str, torch.Tensor], prompt,
             max_new_tokens: int, *, seq_len: Optional[int] = None,
             device="cuda") -> torch.Tensor:
    """Greedy generation from dense parameters ({path: leaf}); (B,
    Sp+new) int64 tokens."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, dtype=torch.int64, device=dev)
    B, Sp = prompt.shape
    cache = model.init_cache(params, B, seq_len or (Sp + max_new_tokens),
                             device=dev)

    def step_fn(arrays, c, tok):
        return model.decode_step(arrays, c, {"tokens": tok})

    new, _ = make_generator(step_fn, max_new_tokens)(params, cache, prompt)
    return torch.cat([prompt, new], dim=1)


class ServeEngine(NamedTuple):
    """A serving plan for one (model, ServeState) pair.

    ``step(arrays, cache, tok (B, 1), live=None) -> (logits (B, 1, V),
    cache)``: a scalar ``cache.pos`` is the single-request path, a (B,)
    one the per-lane path with an optional (B,) ``live`` mask.
    ``arrays_of(sstate, cache=None)`` builds the step's arrays for any
    state of this engine's specs and codec (in cached mode merging the
    hot-block cache's snapshot), which is the hot-swap path.
    """

    step: Callable[..., Any]
    arrays_of: Callable[..., Dict[str, Any]]
    init_cache: Callable[[int, int], Any]
    init_lane_cache: Callable[[int, int], Any]
    mode: str


def build_serve_engine(model: Model, sstate: ServeState, *,
                       mode: str = "streaming", impl: Optional[str] = None,
                       device="cuda") -> ServeEngine:
    """Build the decode step for a dense-family decoder in ``mode``.

    ``impl`` picks the streaming impl (``"cuda"`` or ``"chunked"``;
    default by the tensors' device); the load and cached sources follow
    the tensors' device.  ``sstate`` must live on ``device``.
    """
    check_mode(mode)
    dev = resolve_device(device)
    if sstate.device.type != dev.type:
        raise ValueError(f"serve state lives on {sstate.device}, engine "
                         f"asked for {dev}")
    cfg = model.cfg
    if cfg.family not in ("dense", "vlm") or cfg.moe is not None:
        raise NotImplementedError(
            "the serving engine covers the dense decoder family; got "
            f"family={cfg.family!r}")
    specs = sstate.zspecs.specs
    qbits, qpacked = sstate.qbits, sstate.qpacked
    for path in specs:
        if path.rsplit("/", 1)[-1] in _DENSE_ONLY:
            raise NotImplementedError(
                f"engine expects bias/norm leaves dense, got zampled {path!r}")

    def arrays_of(s: ServeState, cache=None) -> Dict[str, Any]:
        if mode == "load":
            return {"weights": reconstruct_resident(s),
                    "dense": dict(s.dense)}
        out = s.arrays()
        if mode == "cached":
            if cache is None:
                raise ValueError("mode='cached' needs the HotBlockCache: "
                                 "arrays_of(sstate, cache=hot_block_cache)")
            out.update(cache.arrays())
        return out

    def linear(arrays, path, layer, x2d):
        """x2d (B, d_in) @ leaf[layer] -> (B, d_out) float32."""
        spec = specs.get(path)
        if spec is None:
            w = arrays["dense"][path]
            return x2d @ (w[layer] if w.ndim == 3 else w)
        if mode == "load":
            return ops.serve_resident_matmul(spec, arrays["weights"][path],
                                             x2d, group=layer)
        if mode == "cached":
            return ops.serve_cached_matmul(
                spec, arrays["words"][path], arrays["step"], x2d,
                arrays["pool"], arrays["slots"][path][layer], group=layer,
                qbits=qbits, qpacked=qpacked)
        if x2d.shape[0] == 1:  # kernel 11, the B=1 form of kernel 12
            return ops.serve_matvec(spec, arrays["words"][path],
                                    arrays["step"], x2d[0], group=layer,
                                    qbits=qbits, qpacked=qpacked,
                                    impl=impl)[None]
        return ops.serve_matmul(spec, arrays["words"][path], arrays["step"],
                                x2d, group=layer, qbits=qbits,
                                qpacked=qpacked, impl=impl)

    def embed_rows(arrays, tokens):
        spec = specs.get("embed")
        if spec is None:
            return arrays["dense"]["embed"][tokens]
        if mode == "load":
            return arrays["weights"]["embed"][tokens]
        return ops.serve_embed_rows(spec, arrays["words"]["embed"],
                                    arrays["step"], tokens, qbits=qbits,
                                    qpacked=qpacked)

    @torch.no_grad()
    def step(arrays, cache: KVCache, tokens, live=None):
        dense = arrays["dense"]
        return decode_layers(
            cfg, embed_rows(arrays, tokens), cache,
            lambda path, layer, x2d: linear(arrays, path, layer, x2d),
            dense.__getitem__, live)

    def init_cache(batch_size: int, seq_len: int) -> KVCache:
        return model.init_cache(None, batch_size, seq_len, device=dev)

    def init_lane_cache(lanes: int, seq_len: int) -> KVCache:
        c = init_cache(lanes, seq_len)
        return c._replace(pos=torch.zeros((lanes,), dtype=torch.int64,
                                          device=dev))

    return ServeEngine(step=step, arrays_of=arrays_of, init_cache=init_cache,
                       init_lane_cache=init_lane_cache, mode=mode)


def serve_generate(model: Model, sstate: ServeState, prompt, max_new_tokens: int,
                   *, mode: str = "streaming", impl: Optional[str] = None,
                   seq_len: Optional[int] = None, cache=None,
                   device="cuda") -> torch.Tensor:
    """Greedy generation from a ServeState; (B, Sp+new) int64 tokens.
    ``mode="cached"`` serves through ``cache`` (a warmed
    ``serve.cache.HotBlockCache``).  Every mode gives the same tokens."""
    engine = build_serve_engine(model, sstate, mode=mode, impl=impl,
                                device=device)
    prompt = torch.as_tensor(prompt, dtype=torch.int64,
                             device=resolve_device(device))
    B, Sp = prompt.shape
    kv = engine.init_cache(B, seq_len or (Sp + max_new_tokens))
    run = make_generator(engine.step, max_new_tokens)
    new, _ = run(engine.arrays_of(sstate, cache=cache), kv, prompt)
    return torch.cat([prompt, new], dim=1)


def serve_from_compressed(model: Model, zspecs: ZamplingSpecs,
                          masks: Dict[str, torch.Tensor],
                          dense: Dict[str, torch.Tensor], prompt,
                          max_new_tokens: int, **kw) -> torch.Tensor:
    """Deployment from the compressed (masks, dense) artifact:
    reconstruct every leaf once (``weights_from_masks``), then
    ``generate``.  Storage n bits and the dense leaves, against 32 m."""
    params = weights_from_masks(zspecs, masks, {"dense": dense})
    return generate(model, params, prompt, max_new_tokens, **kw)
