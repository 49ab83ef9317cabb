"""Multi-round training: R federated rounds as a Python loop.

The JAX package's ``train/fit.py`` carries R rounds through one
``lax.scan`` with round keys ``jax.random.split(key, R)``.  That split
has no torch twin, so ``federated_fit`` takes the R round words
themselves: round r runs ``federated_round(..., key=words[r],
round_index=r)``, as the JAX package's round does with a word key.
Partial participation threads through as per-round rows: ``client_ids``
and ``weights`` of shape (R, K), and one ``FaultPlan`` whose draws key
on the round index.  ``sharded_client_fit`` is the same loop over
``sharded_client_update`` on this rank's client (the JAX package runs
it inside ``shard_map``), with this rank's (R,) ids and weights.

``streamed_federated_fit`` drives the rounds from a host-side cohort
stream (``data.cohort_batch_stream``): while round r runs on the card,
round r+1's ids, weights and batches are copied there from pinned host
memory without blocking, and nothing on the round's path waits on the
device, so staging overlaps compute.  Its rounds are
``federated_fit``'s on the same stream, bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from ..core.federated import (FederatedConfig, LossFn, federated_round,
                              sharded_client_update)
from ..core.zampling import ZamplingSpecs
from ..device import resolve_device
from ..optim import Optimizer


def stack_metrics(rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-round metric dicts -> {key: (R,) tensor or numpy array}."""
    out = {}
    for key in rows[0]:
        vals = [row[key] for row in rows]
        out[key] = (torch.stack(vals) if isinstance(vals[0], torch.Tensor)
                    else np.asarray(vals))
    return out


def _per_round(x, r: int, rounds: int, name: str):
    """Row r of an (R, ...) participation slab, None when not given."""
    if x is None:
        return None
    if len(x) != rounds:
        raise ValueError(f"{name} has {len(x)} rows, expected {rounds} "
                         "(one a round)")
    return x[r]


def _fit(one_round, state, round_batches, words: Sequence[int],
         client_ids=None, weights=None):
    """R rounds of ``one_round(state, batch, word, r, ids, weights)``;
    returns (state', metrics stacked to (R,))."""
    rows, rounds = [], len(words)
    for r in range(rounds):
        batch = {name: v[r] for name, v in round_batches.items()}
        state, metrics = one_round(
            state, batch, int(words[r]), r,
            _per_round(client_ids, r, rounds, "client_ids"),
            _per_round(weights, r, rounds, "weights"))
        rows.append(metrics)
    return state, stack_metrics(rows)


def federated_fit(zspecs: ZamplingSpecs, state: Dict[str, Any],
                  loss_fn: LossFn, round_batches, words: Sequence[int],
                  cfg: FederatedConfig, opt: Optional[Optimizer] = None, *,
                  client_ids=None, weights=None, faults=None,
                  impl: Optional[str] = None, device="cuda"):
    """R rounds; ``round_batches`` is {name: (R, K, E, B, ...)} and
    ``words`` the (R,) uint32 round words; ``client_ids`` and
    ``weights`` (R, K) rows of the rounds' cohorts, ``faults`` a
    ``FaultPlan``.  Returns (state', metrics stacked to (R,))."""
    return _fit(lambda st, batch, word, r, ids, w: federated_round(
        zspecs, st, loss_fn, batch, word, cfg, opt, round_index=r,
        client_ids=ids, weights=w, faults=faults, impl=impl,
        device=device), state, round_batches, words, client_ids, weights)


def _staged(item, dev: torch.device):
    """One round of a cohort stream, ``(ids, weights, x, y)`` on the
    host, on ``dev``: int64 ids and weights, the batches as they are.
    To a card the copies go from pinned memory without blocking."""
    ids, weights, x, y = item
    host = [torch.from_numpy(np.asarray(ids).astype(np.int64)),
            torch.from_numpy(np.asarray(weights).astype(np.int64)),
            torch.from_numpy(np.ascontiguousarray(x)),
            torch.from_numpy(np.ascontiguousarray(y))]
    if dev.type != "cuda":
        return host
    return [t.pin_memory().to(dev, non_blocking=True) for t in host]


def streamed_federated_fit(zspecs: ZamplingSpecs, state: Dict[str, Any],
                           loss_fn: LossFn, stream: Iterator,
                           words: Sequence[int], cfg: FederatedConfig,
                           opt: Optional[Optimizer] = None, *, faults=None,
                           impl: Optional[str] = None, device="cuda"):
    """``len(words)`` rounds from a cohort stream yielding ``(ids,
    weights, x, y)`` a round (``data.cohort_batch_stream``).

    Round r+1's cohort is staged on ``device`` while round r runs: the
    copies are issued right after round r is dispatched, and the round's
    widths, skip flag and counters stay device tensors, so the loop never
    waits on the card.  With ``cfg.stream_chunk`` no (K, lanes) upload
    slab exists either.  Round r is ``federated_round(..., key=words[r],
    round_index=r, client_ids=ids, weights=weights)``, so the result is
    ``federated_fit``'s on the stacked stream, bit for bit.  Returns
    (state', metrics stacked to (R,))."""
    dev = resolve_device(device)
    rows = []
    nxt = _staged(next(stream), dev)
    for r, word in enumerate(words):
        ids, weights, x, y = nxt
        state, metrics = federated_round(
            zspecs, state, loss_fn, {"x": x, "y": y}, int(word), cfg, opt,
            round_index=r, client_ids=ids, weights=weights, faults=faults,
            impl=impl, device=dev)
        if r + 1 < len(words):  # staged while round r runs
            nxt = _staged(next(stream), dev)
        rows.append(metrics)
    return state, stack_metrics(rows)


def sharded_client_fit(zspecs: ZamplingSpecs, state: Dict[str, Any],
                       loss_fn: LossFn, round_batches, words: Sequence[int],
                       cfg: FederatedConfig, opt: Optional[Optimizer] = None,
                       *, group=None, constraints=None, row_sharding=None,
                       client_ids=None, weights=None, faults=None,
                       impl: Optional[str] = None, device="cuda"):
    """R rounds of ``sharded_client_update`` on this rank's client;
    ``round_batches`` is its {name: (R, E, B, ...)} and ``words`` the
    (R,) round words, the same on every rank; ``client_ids`` and
    ``weights`` this rank's (R,) global ids and sample counts.  Returns
    (state', metrics stacked to (R,)), the same on every rank of a data
    group.  On a grid ``group`` is the data group and ``row_sharding``
    the model AxisGroup (the state: this rank's slices)."""
    return _fit(lambda st, batch, word, r, cid, w: sharded_client_update(
        zspecs, st, loss_fn, batch, word, cfg, opt, group=group,
        constraints=constraints, row_sharding=row_sharding, round_index=r,
        client_id=cid, weight=w, faults=faults, impl=impl, device=device),
        state, round_batches, words, client_ids, weights)
