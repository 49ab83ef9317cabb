"""Optimizers as (init, update) pairs over flat dicts of tensors.

The JAX package's ``optim/optimizers.py``: plain SGD for the federated
round's local steps, Adam (the paper's local training), a global-norm
clip and left-to-right chaining.  A JAX optimizer maps over a pytree;
here the trainable state is one flat ``{path: tensor}`` dict, and the
optimizer state's dicts (``AdamState.mu``/``nu``) are keyed the same.

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple

import torch


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]


def apply_updates(params, updates):
    """params + updates, leaf by leaf, in each parameter's dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def sgd(lr: float) -> Optimizer:
    """updates = -lr * grads, leaf by leaf, with -lr in each gradient's
    dtype: JAX takes the Python float as weakly typed, so a bf16 leaf's
    update is bf16(-lr) * g, rounded to bf16."""

    def init(params):
        del params
        return ()

    def update(grads, state, params=None):
        del params
        return {k: g * torch.tensor(-lr, dtype=g.dtype)
                for k, g in grads.items()}, state

    return Optimizer(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor  # () int32, the number of updates taken
    mu: Dict[str, torch.Tensor]  # f32 first moments
    nu: Dict[str, torch.Tensor]  # f32 second moments


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam with the bias corrections ``1 - b**t`` taken in f32, as the
    JAX package takes them."""

    def init(params):
        dev = next(iter(params.values())).device

        def zeros():
            return {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()}

        return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                         zeros(), zeros())

    def update(grads, state, params=None):
        del params
        step = state.step + 1
        mu = {k: b1 * m + (1 - b1) * grads[k] for k, m in state.mu.items()}
        nu = {k: b2 * v + (1 - b2) * grads[k] * grads[k]
              for k, v in state.nu.items()}
        t = step.to(torch.float32)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        upd = {k: -lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
               for k in mu}
        return upd, AdamState(step, mu, nu)

    return Optimizer(init, update)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    """Scale all updates by min(1, max_norm / global L2 norm)."""

    def init(params):
        del params
        return ()

    def update(grads, state, params=None):
        del params
        norm = torch.sqrt(sum(torch.sum(torch.square(g))
                              for g in grads.values()))
        scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
        return {k: g * scale for k, g in grads.items()}, state

    return Optimizer(init, update)


def chain(*opts: Optimizer) -> Optimizer:
    """Left-to-right composition; each stage transforms the updates."""

    def init(params):
        return tuple(o.init(params) for o in opts)

    def update(grads, state, params=None):
        new_states = []
        upd = grads
        for o, s in zip(opts, state):
            upd, ns = o.update(upd, s, params)
            new_states.append(ns)
        return upd, tuple(new_states)

    return Optimizer(init, update)
