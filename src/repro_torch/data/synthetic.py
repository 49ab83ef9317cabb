"""Synthetic classification data, numpy only.

A copy of the JAX package's ``data/synthetic.py``: the same code, so
the same seed gives the same arrays bit for bit.
``make_teacher_dataset`` builds an MNIST-shaped (784 -> 10) task from
random class prototypes plus Gaussian jitter, in the role MNIST plays
in the paper; ``lm_token_batches`` streams next-token batches of a
Markov chain for the LM training entry point.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass(frozen=True)
class SyntheticClassification:
    x_train: np.ndarray  # (N, 784) float32
    y_train: np.ndarray  # (N,) int32
    x_test: np.ndarray
    y_test: np.ndarray

    def batches(self, batch_size: int, seed: int = 0
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.RandomState(seed)
        n = len(self.x_train)
        while True:
            idx = rng.randint(0, n, batch_size)
            yield self.x_train[idx], self.y_train[idx]


def make_teacher_dataset(
    n_train: int = 12_000,
    n_test: int = 2_000,
    dim: int = 784,
    n_classes: int = 10,
    seed: int = 0,
    noise: float = 0.35,
) -> SyntheticClassification:
    rng = np.random.RandomState(seed)
    protos = rng.randn(n_classes, dim).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)

    def sample(n):
        y = rng.randint(0, n_classes, n)
        x = 1.5 * protos[y] + noise * rng.randn(n, dim).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(n_train)
    x_te, y_te = sample(n_test)
    return SyntheticClassification(x_tr, y_tr, x_te, y_te)


def lm_token_batches(vocab: int, batch: int, seq: int, seed: int = 0
                     ) -> Iterator[np.ndarray]:
    """Markov-chain token stream (learnable bigram structure)."""
    rng = np.random.RandomState(seed)
    # sparse row-stochastic transition with a few preferred successors
    succ = rng.randint(0, vocab, (vocab, 4))
    while True:
        out = np.empty((batch, seq), np.int32)
        state = rng.randint(0, vocab, batch)
        for t in range(seq):
            out[:, t] = state
            pick = succ[state, rng.randint(0, 4, batch)]
            explore = rng.rand(batch) < 0.1
            state = np.where(explore, rng.randint(0, vocab, batch), pick)
        yield out
