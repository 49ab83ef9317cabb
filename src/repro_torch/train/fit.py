"""Multi-round training: R federated rounds as a Python loop.

The JAX package's ``train/fit.py`` carries R rounds through one
``lax.scan`` with round keys ``jax.random.split(key, R)``.  That split
has no torch twin, so ``federated_fit`` takes the R round words
themselves: round r runs ``federated_round(..., key=words[r],
round_index=r)``, as the JAX package's round does with a word key.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..core.federated import FederatedConfig, LossFn, federated_round
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


def federated_fit(zspecs: ZamplingSpecs, state: Dict[str, Any],
                  loss_fn: LossFn, round_batches, words: Sequence[int],
                  cfg: FederatedConfig, opt: Optional[Optimizer] = None, *,
                  impl: Optional[str] = None, device="cuda"):
    """R rounds; ``round_batches`` is {name: (R, K, E, B, ...)} and
    ``words`` the (R,) uint32 round words.  Returns (state', metrics
    stacked to (R,))."""
    rows = []
    for r in range(len(words)):
        batch = {name: v[r] for name, v in round_batches.items()}
        state, metrics = federated_round(
            zspecs, state, loss_fn, batch, int(words[r]), cfg, opt,
            round_index=r, impl=impl, device=device)
        rows.append(metrics)
    return state, stack_metrics(rows)
