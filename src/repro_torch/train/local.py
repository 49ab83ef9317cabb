"""LOCAL ZAMPLING (paper §1.3, the centralized version) and evaluation.

The JAX package's ``train/local.py``, which drives the paper's own
experiments (Table 2, App. A, App. B.1): train the scores with a fresh
mask per forward pass (``mode="sample"``) or the expected network
(``mode="continuous"``), Adam, and early stopping on the expected
network's metric with patience and ``min_delta``.

The JAX trainer splits a PRNG key for every step and draws network i of
an evaluation at ``jax.random.fold_in(key, i)``; neither has a torch
twin, so the port takes the uint32 draw words themselves: one per
training step, one per sampled network.  The expected and discretized
networks draw nothing and need no word.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from ..core.zampling import MaskProgram, ZamplingSpecs, sample_weights, state_to
from ..device import as_tensor, resolve_device
from ..optim import Optimizer, adam, apply_updates


@dataclass(frozen=True)
class LocalTrainConfig:
    """The JAX package's fields and defaults.  ``seed`` seeds the JAX
    trainer's PRNG key; the port's trainer takes draw words instead, so
    it keeps the field for parity and refuses any other value."""

    steps: int = 500
    lr: float = 1e-3
    mode: str = "sample"  # sample | continuous
    eval_every: int = 50
    patience: int = 10  # evaluations without improvement
    min_delta: float = 1e-4
    seed: int = 0

    def __post_init__(self):
        if self.seed != 0:
            raise ValueError(
                f"seed={self.seed}: the port draws each step's mask at the "
                "draw word passed to train_local_zampling, not from a seed; "
                "pass other words instead")


def _flat(state) -> Dict[str, torch.Tensor]:
    return {**state["scores"], **state["dense"]}


def _nested(zspecs: ZamplingSpecs, flat) -> Dict[str, Any]:
    return {"scores": {p: flat[p] for p in zspecs.specs},
            "dense": {p: flat[p] for p in zspecs.dense_paths}}


def train_step(zspecs: ZamplingSpecs, state, opt_state, batch, word,
               loss_fn: Callable, opt: Optimizer, *, mode: str = "sample",
               impl: Optional[str] = None):
    """One step of the JAX trainer's jitted ``train_step``: the network
    at draw word ``word`` (``mode`` ``sample``, or ``continuous``, which
    draws nothing), the loss and its gradient in every score and dense
    leaf, the optimizer's update.  Returns (state',
    opt_state', loss, grads {"scores", "dense"}).  The optimizer sees
    the flat {path: leaf} dict."""
    program = MaskProgram(zspecs, mode=mode, impl=impl)
    leaves = {p: t.detach().requires_grad_(True)
              for p, t in _flat(state).items()}
    params = program.weights({p: leaves[p] for p in zspecs.specs},
                             {p: leaves[p] for p in zspecs.dense_paths}, word)
    loss = loss_fn(params, batch)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    updates, opt_state = opt.update(grads, opt_state, leaves)
    new = apply_updates({p: t.detach() for p, t in leaves.items()}, updates)
    return (_nested(zspecs, new), opt_state, loss.detach(),
            _nested(zspecs, grads))


def train_local_zampling(zspecs: ZamplingSpecs, state: Dict[str, Any],
                         loss_fn: Callable, batch_iter: Iterator,
                         cfg: LocalTrainConfig,
                         words: Optional[Sequence[int]],
                         eval_fn: Optional[Callable] = None,
                         optimizer: Optional[Optimizer] = None, *,
                         impl: Optional[str] = None, device="cuda"):
    """Up to ``cfg.steps`` steps; step t draws at ``words[t]`` (sample
    mode; continuous mode takes ``words=None``).  ``batch_iter`` yields
    {name: array} batches; ``eval_fn(params)`` (higher is better) scores
    the expected network every ``cfg.eval_every`` steps and stops the
    run after ``cfg.patience`` evaluations without a gain above
    ``cfg.min_delta``.  Returns (state, {"loss": [...], "eval": [...]})."""
    if cfg.mode == "sample" and (words is None or len(words) < cfg.steps):
        raise ValueError(f"sample mode draws at one word per step: "
                         f"{cfg.steps} words needed")
    dev = resolve_device(device)
    opt = optimizer or adam(cfg.lr)
    state = state_to(zspecs, state, dev)
    opt_state = opt.init(_flat(state))
    history = {"loss": [], "eval": []}
    best, stale = -np.inf, 0
    for t in range(cfg.steps):
        batch = {k: as_tensor(v, dev) for k, v in next(batch_iter).items()}
        word = words[t] if words is not None else 0
        state, opt_state, loss, _ = train_step(zspecs, state, opt_state,
                                               batch, word, loss_fn, opt,
                                               mode=cfg.mode, impl=impl)
        history["loss"].append(float(loss))
        if eval_fn is not None and (t + 1) % cfg.eval_every == 0:
            with torch.no_grad():
                params = MaskProgram(zspecs, mode="continuous",
                                     impl=impl).weights(
                    state["scores"], state["dense"], 0)
                m = float(eval_fn(params))
            history["eval"].append(m)
            if m > best + cfg.min_delta:
                best, stale = m, 0
            else:
                stale += 1
                if stale >= cfg.patience:
                    break
    return state, history


def evaluate(zspecs: ZamplingSpecs, state: Dict[str, Any],
             metric_fn: Callable, words: Optional[Sequence[int]] = None, *,
             mode: str = "sample", carried: Optional[str] = None,
             impl: Optional[str] = None, device="cuda"):
    """(mean, std) of ``metric_fn(params)`` over one sampled network per
    draw word (the paper's "sampled accuracy"), or (value, 0.0) of the
    expected (``mode="continuous"``) or discretized network, which take
    no words.  ``carried`` names the codec of an encoded score state (a
    packed codec's lanes need it); a u8/u16 or packed carry is drawn
    from straight, in the kernel."""
    with torch.no_grad():
        if mode in ("continuous", "discretize"):
            params = sample_weights(zspecs, state, 0, mode=mode,
                                    carried=carried, impl=impl, device=device)
            return float(metric_fn(params)), 0.0
        vals = [float(metric_fn(sample_weights(
            zspecs, state, w, mode=mode, carried=carried, impl=impl,
            device=device))) for w in words]
    return float(np.mean(vals)), float(np.std(vals))
