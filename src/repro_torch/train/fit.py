"""Multi-round training: R federated rounds as a Python loop.

The JAX package's ``train/fit.py`` carries R rounds through one
``lax.scan`` with round keys ``jax.random.split(key, R)``.  That split
has no torch twin, so ``federated_fit`` takes the R round words
themselves: round r runs ``federated_round(..., key=words[r],
round_index=r)``, as the JAX package's round does with a word key.
``sharded_client_fit`` is the same loop over ``sharded_client_update``
on this rank's client (the JAX package runs it inside ``shard_map``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..core.federated import (FederatedConfig, LossFn, federated_round,
                              sharded_client_update)
from ..core.zampling import ZamplingSpecs
from ..optim import Optimizer


def stack_metrics(rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-round metric dicts -> {key: (R,) tensor or numpy array}."""
    out = {}
    for key in rows[0]:
        vals = [row[key] for row in rows]
        out[key] = (torch.stack(vals) if isinstance(vals[0], torch.Tensor)
                    else np.asarray(vals))
    return out


def _fit(one_round, state, round_batches, words: Sequence[int]):
    """R rounds of ``one_round(state, batch, word, r)``; returns (state',
    metrics stacked to (R,))."""
    rows = []
    for r in range(len(words)):
        batch = {name: v[r] for name, v in round_batches.items()}
        state, metrics = one_round(state, batch, int(words[r]), r)
        rows.append(metrics)
    return state, stack_metrics(rows)


def federated_fit(zspecs: ZamplingSpecs, state: Dict[str, Any],
                  loss_fn: LossFn, round_batches, words: Sequence[int],
                  cfg: FederatedConfig, opt: Optional[Optimizer] = None, *,
                  impl: Optional[str] = None, device="cuda"):
    """R rounds; ``round_batches`` is {name: (R, K, E, B, ...)} and
    ``words`` the (R,) uint32 round words.  Returns (state', metrics
    stacked to (R,))."""
    return _fit(lambda st, batch, word, r: federated_round(
        zspecs, st, loss_fn, batch, word, cfg, opt, round_index=r,
        impl=impl, device=device), state, round_batches, words)


def sharded_client_fit(zspecs: ZamplingSpecs, state: Dict[str, Any],
                       loss_fn: LossFn, round_batches, words: Sequence[int],
                       cfg: FederatedConfig, opt: Optional[Optimizer] = None,
                       *, group=None, impl: Optional[str] = None,
                       device="cuda"):
    """R rounds of ``sharded_client_update`` on this rank's client;
    ``round_batches`` is its {name: (R, E, B, ...)} and ``words`` the
    (R,) round words, the same on every rank.  Returns (state', metrics
    stacked to (R,)), the same on every rank."""
    return _fit(lambda st, batch, word, r: sharded_client_update(
        zspecs, st, loss_fn, batch, word, cfg, opt, group=group,
        round_index=r, impl=impl, device=device), state, round_batches,
        words)
