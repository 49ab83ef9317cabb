"""The client population and the round's cohort.

The JAX package's ``fault/population.py``.  N clients with per-client
sample counts (the Dirichlet split's sizes), which weigh each upload in
the partial-participation round.  Client i's priority in round r is
``hash_u32(seed, COHORT_CTR, r, i)``, and the cohort is the K smallest
priorities, ties by index (a stable sort), returned in ascending id
order.  It depends on (seed, round) only, so the host that stages the
data and the round that derives the draw words see the same clients.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.hashrng import hash_u32
from ..device import resolve_device

# counter space of the cohort stream: (seed, COHORT_CTR, round, client)
COHORT_CTR = 0x0020_0000


@dataclass(frozen=True)
class ClientPopulation:
    """N clients; ``sample_counts`` their (N,) dataset sizes, or None for
    weight 1 each (whose weighted round is the plain round's)."""

    num_clients: int
    sample_counts: Optional[tuple] = None
    seed: int = 0

    def __post_init__(self):
        if self.num_clients < 1:
            raise ValueError(
                f"population needs >= 1 client, got {self.num_clients}")
        if self.sample_counts is not None:
            counts = np.asarray(self.sample_counts)
            if counts.shape != (self.num_clients,):
                raise ValueError(f"sample_counts shape {counts.shape} != "
                                 f"({self.num_clients},)")
            if (counts < 1).any():
                raise ValueError(
                    "per-client sample counts must be >= 1 (a weight-0 "
                    "client can never contribute; drop it from the "
                    "population instead)")
            object.__setattr__(self, "sample_counts",
                               tuple(int(c) for c in counts))

    def counts(self, device="cpu") -> torch.Tensor:
        """(N,) int64 sample counts (ones if unset)."""
        if self.sample_counts is None:
            return torch.ones((self.num_clients,), dtype=torch.int64,
                              device=device)
        return torch.tensor(self.sample_counts, dtype=torch.int64,
                            device=device)

    def priorities(self, round_index: int, device="cpu") -> torch.Tensor:
        """(N,) uint32 priority words of one round, in int64."""
        ids = torch.arange(self.num_clients, dtype=torch.int64,
                           device=device)
        return hash_u32(self.seed, COHORT_CTR, int(round_index) & 0xFFFFFFFF,
                        ids)

    def sample_cohort(self, round_index: int, cohort_size: int, *,
                      device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
        """The round's cohort on ``device``: (client ids ascending,
        their weights), (cohort_size,) int64 each."""
        if not 1 <= cohort_size <= self.num_clients:
            raise ValueError(
                f"cohort_size {cohort_size} not in [1, {self.num_clients}]")
        dev = resolve_device(device)
        order = torch.argsort(self.priorities(round_index, dev), stable=True)
        ids = torch.sort(order[:cohort_size]).values
        return ids, self.counts(dev)[ids]

    def cohort_np(self, round_index: int, cohort_size: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """``sample_cohort`` on the host, as uint32 numpy arrays: what
        the data stager feeds a round."""
        ids, weights = self.sample_cohort(round_index, cohort_size,
                                          device="cpu")
        return (ids.numpy().astype(np.uint32),
                weights.numpy().astype(np.uint32))
