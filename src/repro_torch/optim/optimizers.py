"""Optimizers as (init, update) pairs over dicts of tensors.

The JAX package's ``optim/optimizers.py``, SGD only: the federated
round's local steps use plain SGD at the paper's learning rate.  Adam
comes with local training.

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = {k: p + updates[k]}
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]


def sgd(lr: float) -> Optimizer:
    """updates = -lr * grads, leaf by leaf (a flat dict)."""

    def init(params):
        del params
        return ()

    def update(grads, state, params=None):
        del params
        return {k: -lr * g for k, g in grads.items()}, state

    return Optimizer(init, update)
