"""End-to-end LM training: federated zampling of a decoder LM.

The JAX package's ``launch/train.py``, with its flags, defaults,
``scaled()`` and printed lines: an assigned architecture (size-scaled
below ``--scale 1``) trains by federated zampling on the synthetic
Markov LM stream, K clients taking E local SGD steps a round, ``mean``
uploads of f32 masks and the ``f32`` downlink.  Each local step runs
the fused sample-reconstruct forward (CUDA kernel 8) and the transpose
backward the gate ``REPRO_BWD_PLAN`` names (``core.transpose_plan``).
At full width (``--scale 1.0``, bf16 leaves) the transpose plans of
qwen2-0.5b would need ~100 GB of device memory, so full width trains
only under ``REPRO_BWD_PLAN=scatter`` (kernel 4, which regenerates Q
and holds no plan):

  REPRO_BWD_PLAN=scatter python -m repro_torch.launch.train \\
      --scale 1.0 --rounds 3 --out runs/full
  python -m repro_torch.launch.train --device cpu --scale 0.01 \\
      --rounds 2 --local-steps 2 --batch 2 --seq 16 --out runs/tiny

Where the JAX entry point draws from ``jax.random`` at fixed keys (the
scores, the dense leaves' init, a round key split per round), this one
draws from numpy at fixed seeds: scores U(0, 1) and each round's uint32
word from ``RandomState(0)``, dense leaves from
``models.model.init_dense`` at seed 0.
It writes ``history.json`` (the per-round losses) into ``--out``, and
no checkpoint yet: the JAX checkpoint's bf16 leaves need
``ml_dtypes``, which the card's machine lacks (ROADMAP queue 1, item
8).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..configs import get_arch
from ..core.federated import FederatedConfig, federated_round
from ..core.zampling import ZamplingConfig, build_specs, init_state
from ..data import lm_token_batches
from ..device import resolve_device
from ..models.model import init_dense, loss_fn, param_template


def scaled(cfg, scale: float):
    """Shrink width/depth by ~scale (keeps the family & flavour)."""
    if scale >= 1.0:
        return cfg
    d = int(cfg.d_model * scale**0.5) // 64 * 64 or 64
    L = max(2, int(cfg.n_layers * scale**0.5))
    heads = max(1, int(cfg.n_heads * scale**0.5)) if cfg.n_heads else 0
    kv = max(1, min(cfg.n_kv, heads)) if cfg.n_kv else 0
    if heads:
        while heads % kv:
            kv -= 1
    return dataclasses.replace(
        cfg, d_model=d, n_layers=L, n_heads=heads, n_kv=kv,
        head_dim=64 if heads else 0,
        d_ff=int(cfg.d_ff * scale**0.5) // 64 * 64 if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 8192), dtype="float32",
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--compression", type=float, default=8.0)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--out", default="runs/demo")
    ap.add_argument("--device", default="cuda")
    return ap


@dataclasses.dataclass
class LMRun:
    """What a run trains: the config, the spec set, the round config,
    the state, the loss, the token stream and the round words."""

    cfg: object
    zspecs: object
    fcfg: FederatedConfig
    state: dict
    loss: Callable
    stream: object
    words: list
    args: argparse.Namespace
    device: torch.device

    def batch(self):
        """The next round's {tokens, labels}: (K, E, B, S) each."""
        a = self.args
        toks = next(self.stream).reshape(a.clients, a.local_steps, a.batch,
                                         a.seq + 1)
        return {"tokens": toks[..., :-1], "labels": toks[..., :-1]}


def build(args: argparse.Namespace) -> LMRun:
    """The configuration, spec set, initial state and data of a run."""
    dev = resolve_device(args.device)
    cfg = scaled(get_arch(args.arch), args.scale)
    zspecs = build_specs(param_template(cfg), ZamplingConfig(
        compression=args.compression, d=args.d, min_size=4096))
    rng = np.random.RandomState(0)
    scores = {p: rng.rand(s.n).astype(np.float32)
              for p, s in zspecs.specs.items()}
    dense = init_dense(cfg, zspecs.dense_paths, 0)
    state = init_state(zspecs, scores, dense, device=dev)
    words = [int(w) for w in rng.randint(0, 2**32, args.rounds,
                                         dtype=np.uint64)]
    fcfg = FederatedConfig(num_clients=args.clients,
                           local_steps=args.local_steps, local_lr=args.lr)
    stream = lm_token_batches(cfg.vocab, args.clients * args.local_steps
                              * args.batch, args.seq + 1, seed=0)
    return LMRun(cfg, zspecs, fcfg, state, functools.partial(loss_fn, cfg),
                 stream, words, args, dev)


def describe(run: LMRun) -> str:
    zs = run.zspecs
    n_params = sum(int(np.prod(leaf.shape)) for leaf in zs.template.values())
    return (f"[train] arch={run.cfg.name} scaled: {n_params/1e6:.1f}M "
            f"params, reparam {zs.m_total/1e6:.1f}M -> {zs.n_total/1e6:.2f}M "
            f"trainable ({zs.m_total / zs.n_total:.1f}x), client "
            f"upload/round = {zs.n_total/8/1e3:.0f} KB vs naive "
            f"{zs.m_total*4/1e6:.0f} MB")


def train(run: LMRun, on_round: Optional[Callable] = None) -> list:
    """``args.rounds`` rounds from ``run.state`` (updated in place);
    prints a line per round and calls ``on_round(r, state, metrics,
    seconds)`` after each.  Returns the per-round losses."""
    history = []
    for r in range(run.args.rounds):
        batch = run.batch()
        t0 = time.perf_counter()
        run.state, met = federated_round(run.zspecs, run.state, run.loss,
                                         batch, run.words[r], run.fcfg,
                                         device=run.device)
        loss = float(met["loss"])  # waits for the round's last kernel
        dt = time.perf_counter() - t0
        history.append(loss)
        print(f"[round {r:3d}] loss={loss:.4f}  ({dt:.1f}s)", flush=True)
        if on_round is not None:
            on_round(r, run.state, met, dt)
    return history


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    run = build(args)
    print(describe(run), flush=True)
    os.makedirs(args.out, exist_ok=True)
    history = train(run)
    with open(os.path.join(args.out, "history.json"), "w") as f:
        json.dump(history, f)
    print(f"[train] done. loss {history[0]:.3f} -> {history[-1]:.3f}; "
          f"history at {args.out}/history.json (no checkpoint yet)")
    return history


if __name__ == "__main__":
    main()
