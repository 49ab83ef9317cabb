"""Serve a generative LM from the COMPRESSED Zampling artifact, on the
PyTorch port (``src/repro_torch``) of ``examples/serve_compressed.py``.

The deployment object is the encoded score broadcast (u8/u16 wire
words or f32 scores) + dense leaves + one uint32 draw word.  Three
ways to decode against it:

  --mode load       reconstruct w = Q Bern(f(s)) once, serve resident
                    f32 tensors;
  --mode streaming  never materialize a weight: every decode linear
                    regenerates its (window, bm) block inside the
                    contraction (kernels.ops serve half);
  --mode cached     streaming plus the hot-block tile pool: the first
                    --cache-budget-kib of canonical tiles serve
                    resident, the rest stream, the dialable midpoint.

Bit-identical logits in all three (one serve kernel with three weight
sources on the card, one plain tree on the CPU); the resident table
meters the whole node (words + tile pool + lane KV + dense), not the
words only (comm.metering.serve_resident_bytes).

The batched section drives the continuous-batching scheduler: ragged
prompts admitted and retired per step over fixed lanes.  With
--delta, a synthetic converged round (1% of scores move) ships as an
XOR word delta and hot-swaps the live scheduler mid-flight: the
hot-block cache survives, dropping only the tiles whose drawn mask
bits flip.

It differs from the JAX example in one way: the scores, the masks of
the legacy artifact and the 1% perturbation come from
``numpy.random.RandomState`` seeds (the JAX example draws them with
``jax.random``, which has no torch twin), so the tokens differ from the
JAX example's.  Sampling is greedy.  The kernels run on the card
(``--device cuda``, the default); ``--device cpu`` runs their plain
torch versions.

  PYTHONPATH=src python examples/serve_compressed_torch.py --device cpu
  PYTHONPATH=src python examples/serve_compressed_torch.py \\
      --mode cached --delta
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.comm.metering import serve_resident_bytes
from repro_torch.configs import get_arch
from repro_torch.core.zampling import (ZamplingConfig, build_specs,
                                       init_state)
from repro_torch.models.model import build_model, init_dense, param_template
from repro_torch.serve import (ServeConfig, ServeScheduler, apply_delta,
                               build_cache, build_serve_engine,
                               delta_report, make_delta, make_generator,
                               make_serve_state, serve_from_compressed)

DRAW_WORD = 2


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=["load", "streaming", "cached"],
                    default="cached",
                    help="serving mode for the timed generation")
    ap.add_argument("--delta", action="store_true",
                    help="also demo the XOR delta hot-swap round update")
    ap.add_argument("--codec", choices=["f32", "u16", "u8"], default="u8",
                    help="downlink codec carried by the serving state")
    ap.add_argument("--cache-budget-kib", type=int, default=2048,
                    help="hot-block tile pool budget (mode=cached)")
    ap.add_argument("--lanes", type=int, default=4,
                    help="scheduler batch lanes")
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    return ap.parse_args(argv)


def moved_scores(scores, seed=7, frac=0.01, amp=0.05):
    """A synthetic converged round: ``frac`` of the scores move by
    ``amp`` N(0, 1), from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    out = {}
    for p, s in scores.items():
        touch = rng.rand(s.size) < frac
        out[p] = np.where(touch, s + amp * rng.randn(s.size),
                          s).astype(np.float32)
    return out


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    args = parse_args(argv)
    dev = torch.device(args.device)
    cfg = get_arch("qwen2-0.5b").reduced()
    model = build_model(cfg)
    zspecs = build_specs(param_template(cfg),
                         ZamplingConfig(compression=8, d=8, min_size=1024))
    rng = np.random.RandomState(1)
    scores = {p: rng.rand(s.n).astype(np.float32)
              for p, s in zspecs.specs.items()}
    dense = init_dense(cfg, zspecs.dense_paths, seed=0)
    state = init_state(zspecs, scores, dense, device=dev)

    rng = np.random.RandomState(2)
    masks = {p: torch.from_numpy((rng.rand(s.n) < scores[p])
                                 .astype(np.float32)).to(dev)
             for p, s in zspecs.specs.items()}
    mask_bits = sum(int(m.shape[0]) for m in masks.values())
    print(f"compressed artifact: {mask_bits / 8 / 1024:.1f} KiB of masks for "
          f"{zspecs.m_total / 1e6:.1f}M weights "
          f"(+{sum(v.numel() for v in state['dense'].values()) / 1e3:.0f}K "
          f"dense params)")

    prompt = torch.tensor([[5, 17, 42, 7], [1, 2, 3, 4]], device=dev)
    out = serve_from_compressed(model, zspecs, masks, state["dense"], prompt,
                                max_new_tokens=8, seq_len=32, device=dev)
    print("batched generation (legacy mask artifact, reconstruct-on-load):")
    for row in out.tolist():
        print("  ", row)

    # --- the Zampling-native serving state -------------------------------
    sstate = make_serve_state(zspecs, state, DRAW_WORD, downlink=args.codec,
                              dither_word=0, device=dev)
    B, Sp = prompt.shape
    seq_len = Sp + args.new_tokens
    budget = args.cache_budget_kib * 1024

    print(f"\nresident node state ({args.codec} codec; words + cache pool + "
          f"KV + dense) and decode throughput, mode={args.mode} timed:")
    print(f"  {'mode':<11} {'zampled KiB':>12} {'cache KiB':>10} "
          f"{'KV KiB':>7} {'total KiB':>10} {'tok/s':>10}")
    rows = {}
    for mode in ("load", "streaming", "cached"):
        engine = build_serve_engine(model, sstate, mode=mode, device=dev)
        hbc = None
        if mode == "cached":
            hbc = build_cache(sstate, ServeConfig(
                lanes=args.lanes, seq_len=seq_len, cache_budget_bytes=budget,
                mode="cached"))
        arrays = engine.arrays_of(sstate, cache=hbc)
        run = make_generator(engine.step, args.new_tokens)
        cache = engine.init_cache(B, seq_len)
        rows[mode], _ = run(arrays, cache, prompt)
        res = serve_resident_bytes(sstate, budget if mode == "cached" else 0,
                                   mode=mode, kv_cache=cache)
        if mode == args.mode:
            sync(dev)
            t0 = time.perf_counter()
            run(arrays, cache, prompt)
            sync(dev)
            tps = f"{B * args.new_tokens / (time.perf_counter() - t0):10.1f}"
        else:
            tps = f"{'-':>10}"
        print(f"  {mode:<11} {res['zampled_bytes'] / 1024:12.1f} "
              f"{res['cache_bytes'] / 1024:10.1f} "
              f"{res['kv_bytes'] / 1024:7.1f} "
              f"{res['total_bytes'] / 1024:10.1f} {tps}")
    assert torch.equal(rows["load"], rows["streaming"]), \
        "modes must agree bitwise"
    assert torch.equal(rows["load"], rows["cached"]), \
        "cached mode must agree too"
    print("  (modes verified bit-identical; dense leaves "
          f"{sstate.dense_bytes() / 1024:.1f} KiB in all modes)")

    # --- continuous batching ----------------------------------------------
    print(f"\ncontinuous batching: {args.lanes} lanes, ragged prompts, "
          f"mode={args.mode}:")
    ragged = [[5, 17, 42, 7], [1, 2, 3], [9, 9, 1, 0, 3], [4, 4]]
    scfg = ServeConfig(lanes=args.lanes,
                       seq_len=max(len(p) for p in ragged) + args.new_tokens,
                       cache_budget_bytes=budget, mode=args.mode,
                       max_new_tokens=args.new_tokens)
    sched = ServeScheduler(model, sstate, scfg, device=dev)
    rids = {sched.submit(p): p for p in ragged}
    t0 = time.perf_counter()
    results = sched.run()
    dt = time.perf_counter() - t0
    for rid, p in rids.items():
        print("  ", p, "->", results[rid].tolist())
    m = sched.metrics()
    print(f"  {m['completed']} requests in {m['steps']} engine steps "
          f"({sum(len(v) for v in results.values()) / dt:.1f} tok/s)")
    if "cache" in m:
        c = m["cache"]
        print(f"  cache: {c['resident_tiles']}/{c['total_tiles']} tiles "
              f"resident, {c['hits']} hits / {c['misses']} misses")

    if not args.delta:
        return
    print("\ndelta hot-swap (synthetic converged round: 1% of scores move):")
    state2 = init_state(zspecs, moved_scores(scores), dense, device=dev)
    print(f"  {'codec':<6} {'changed':>8} {'flipped':>8} {'delta KiB':>10} "
          f"{'full KiB':>9} {'ratio':>7}")
    for codec in ("f32", "u16", "u8"):
        s1 = make_serve_state(zspecs, state, DRAW_WORD, downlink=codec,
                              dither_word=0, device=dev)
        s2 = make_serve_state(zspecs, state2, DRAW_WORD, downlink=codec,
                              dither_word=0, device=dev)
        rep = delta_report(s1, s2)
        print(f"  {codec:<6} {rep['words_changed']:>8} "
              f"{rep['words_flipped']:>8} "
              f"{rep['delta_bytes'] / 1024:10.1f} "
              f"{rep['full_bytes'] / 1024:9.1f} "
              f"{rep['delta_vs_full']:7.4f}")
    new_state = make_serve_state(zspecs, state2, DRAW_WORD,
                                 downlink=args.codec, dither_word=0,
                                 device=dev)
    delta = make_delta(sstate, new_state)
    patched = apply_delta(sstate, delta)
    assert all(torch.equal(patched.words[p], new_state.words[p])
               for p in new_state.words), "the patch must give round t+1"
    # swap the live scheduler mid-queue: in-flight KV survives, and in
    # cached mode only flipped-bit tiles drop from the pool
    for p in ragged:
        sched.submit(p)
    sched.step_once()
    before = sched.cache.resident_tiles if sched.cache else None
    sched.apply_round_delta(delta)
    results2 = sched.run()
    if sched.cache is not None:
        c = sched.cache.stats()
        print(f"  cache survived swap: {c['invalidations']} tiles "
              f"invalidated of {before}, refilled to "
              f"{c['resident_tiles']}/{c['total_tiles']}")
    print("  post-swap generations (same engine, new words):")
    for rid in sorted(results2)[len(rids):]:
        print("  ", results2[rid].tolist())


if __name__ == "__main__":
    main()
