"""Client partitioning, numpy only: the IID split of the paper's §1.3
and the per-round batch stream, copied from the JAX package's
``data/federated_split.py`` so a seed gives the same arrays.  The
Dirichlet split and the cohort stream come with partial
participation."""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from .synthetic import SyntheticClassification


def iid_client_split(ds: SyntheticClassification, num_clients: int,
                     seed: int = 0) -> List[SyntheticClassification]:
    rng = np.random.RandomState(seed)
    n = len(ds.x_train)
    perm = rng.permutation(n)
    shards = np.array_split(perm, num_clients)
    return [
        SyntheticClassification(
            ds.x_train[s], ds.y_train[s], ds.x_test, ds.y_test
        )
        for s in shards
    ]


def client_batch_stream(
    clients: List[SyntheticClassification],
    batch_size: int,
    local_steps: int,
    seed: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields stacked (K, local_steps, B, ...) batches per round."""
    rng = np.random.RandomState(seed)
    while True:
        xs, ys = [], []
        for c in clients:
            n = len(c.x_train)
            idx = rng.randint(0, n, (local_steps, batch_size))
            xs.append(c.x_train[idx])
            ys.append(c.y_train[idx])
        yield np.stack(xs), np.stack(ys)
