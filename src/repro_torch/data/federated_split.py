"""Client partitioning, numpy only, copied from the JAX package's
``data/federated_split.py`` so a seed gives the same arrays: the IID
split of the paper's §1.3 and its per-round batch stream; the
Dirichlet-beta non-IID split, whose per-client sizes weigh the
partial-participation round; and the cohort stream that stages each
round's sampled clients.
"""

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


def dirichlet_client_split(
    ds: SyntheticClassification,
    num_clients: int,
    beta: float = 0.5,
    seed: int = 0,
) -> Tuple[List[SyntheticClassification], np.ndarray]:
    """Dirichlet-beta non-IID split: for each class, ``q ~ Dir(beta 1_K)``
    apportions its shuffled examples over the K clients.  Returns
    ``(clients, hist)`` with ``hist`` the (K, C) label counts, whose row
    sums are the clients' sample counts (``fault.ClientPopulation``).
    An empty client takes one example from the largest."""
    if beta <= 0:
        raise ValueError(f"beta must be > 0, got {beta}")
    rng = np.random.RandomState(seed)
    y = np.asarray(ds.y_train)
    classes = np.unique(y)
    shards: List[List[np.ndarray]] = [[] for _ in range(num_clients)]
    for c in classes:
        idx = rng.permutation(np.flatnonzero(y == c))
        q = rng.dirichlet(np.full(num_clients, beta))
        cuts = (np.cumsum(q)[:-1] * len(idx)).astype(np.int64)
        for k, part in enumerate(np.split(idx, cuts)):
            shards[k].append(part)
    owned = [np.concatenate(s) if s else np.empty(0, np.int64)
             for s in shards]
    for k in range(num_clients):
        while len(owned[k]) == 0:
            donor = int(np.argmax([len(o) for o in owned]))
            owned[k] = owned[donor][-1:]
            owned[donor] = owned[donor][:-1]
    hist = np.zeros((num_clients, len(classes)), np.int64)
    clients = []
    for k, s in enumerate(owned):
        s = rng.permutation(s)
        for j, c in enumerate(classes):
            hist[k, j] = int(np.sum(y[s] == c))
        clients.append(SyntheticClassification(
            ds.x_train[s], ds.y_train[s], ds.x_test, ds.y_test))
    return clients, hist


def cohort_batch_stream(
    clients: List[SyntheticClassification],
    population,  # fault.ClientPopulation over these clients
    cohort_size: int,
    batch_size: int,
    local_steps: int,
    seed: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Yields ``(client_ids, weights, x, y)`` for round 0, 1, ...: the
    round's cohort (``population.cohort_np``) and batches for exactly
    those clients, x/y stacked (cohort_size, local_steps, batch_size,
    ...)."""
    if len(clients) != population.num_clients:
        raise ValueError(f"{len(clients)} client datasets for a population "
                         f"of {population.num_clients}")
    rng = np.random.RandomState(seed)
    r = 0
    while True:
        ids, weights = population.cohort_np(r, cohort_size)
        xs, ys = [], []
        for cid in ids:
            c = clients[int(cid)]
            idx = rng.randint(0, len(c.x_train), (local_steps, batch_size))
            xs.append(c.x_train[idx])
            ys.append(c.y_train[idx])
        yield ids, weights, np.stack(xs), np.stack(ys)
        r += 1
