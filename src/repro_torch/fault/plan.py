"""Deterministic fault injection on the integer wire.

The JAX package's ``fault/plan.py``.  A ``FaultPlan`` gives each
(round, client) at most one fault:

- **drop**: the client uploads nothing;
- **straggler**: its upload misses the round's cutoff and is left out;
- **corrupt**: its upload's payload is damaged in flight, and the
  server's popcount check (``fault.validate``) leaves it out;
- **duplicate**: its upload arrives twice; it is counted once, and the
  second copy's bytes are metered.

One uniform word ``hash_u32(plan.seed, FAULT_CTR, round, client)``
picks the fault by integer compares against the cumulative rates
scaled to 2^32, so a scenario depends on (seed, round, client) only:
the stacked, streaming and sharded rounds draw the same codes.  The
corruption's garbage words come from ``CORRUPT_CTR``; where XOR with
them would keep an upload's popcount, one more bit flips, so every
injected corruption is detected.

Words and lanes are int64 tensors holding uint32 values, as everywhere
in the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..comm.bitpack import packed_total_popcount
from ..core.hashrng import hash_u32

# counter spaces, disjoint from the mask, dither and cohort streams:
# fault draws (seed, FAULT_CTR, round, client); garbage words (seed,
# tensor_id, CORRUPT_CTR, round, client, lane or coordinate)
FAULT_CTR = 0x0028_0000
CORRUPT_CTR = 0x0030_0000

# fault codes: the value of one (round, client) draw
OK, DROP, STRAGGLER, CORRUPT, DUPLICATE = 0, 1, 2, 3, 4

FAULT_NAMES = ("ok", "drop", "straggler", "corrupt", "duplicate")


@dataclass(frozen=True)
class FaultPlan:
    """Independent per-(round, client) fault rates, summing to at most 1.
    ``FaultPlan()`` runs the participation path with no fault."""

    dropout: float = 0.0
    straggler: float = 0.0
    corrupt: float = 0.0
    duplicate: float = 0.0
    seed: int = 0

    def __post_init__(self):
        rates = (self.dropout, self.straggler, self.corrupt,
                 self.duplicate)
        if any(r < 0 for r in rates):
            raise ValueError(f"fault rates must be >= 0, got {rates}")
        if sum(rates) > 1.0:
            raise ValueError(
                f"fault rates sum to {sum(rates)} > 1 (one fault at "
                f"most per (round, client) draw)")

    def thresholds(self):
        """The cumulative uint32 compare thresholds, as Python ints: the
        JAX package's float64 cumulative sums, rounded the same way."""
        edges = np.cumsum([self.dropout, self.straggler, self.corrupt,
                           self.duplicate])
        return [min(int(round(float(e) * 4294967296.0)), 0xFFFFFFFF)
                for e in edges]


def _round_word(round_index):
    """A round index as the hash takes it: an int (hashed on the host, no
    copy to the card) or an int64 tensor."""
    if isinstance(round_index, torch.Tensor):
        return round_index.to(torch.int64)
    return int(round_index) & 0xFFFFFFFF


def _id_tensor(client_ids, device) -> torch.Tensor:
    """Client ids (one, a sequence, numpy or a tensor) as int64."""
    if isinstance(client_ids, torch.Tensor):
        return client_ids.to(torch.int64)
    arr = np.asarray(client_ids, dtype=np.uint64) & np.uint64(0xFFFFFFFF)
    return torch.as_tensor(arr.astype(np.int64), device=device)


def draw_faults(plan: FaultPlan, round_index, client_ids,
                device="cpu") -> torch.Tensor:
    """Fault codes (int64, OK..DUPLICATE) for the clients of a round;
    ``client_ids`` a (K,) tensor or sequence, or one id (a rank's), on
    ``device`` unless it is a tensor already."""
    u = hash_u32(plan.seed, FAULT_CTR, _round_word(round_index),
                 _id_tensor(client_ids, device))
    t_drop, t_strag, t_corr, t_dup = plan.thresholds()
    code = torch.full_like(u, OK)
    # the JAX package's nested where, innermost first
    for t, c in ((t_dup, DUPLICATE), (t_corr, CORRUPT),
                 (t_strag, STRAGGLER), (t_drop, DROP)):
        code = torch.where(u < t, c, code)
    return code


def _garbage_u32(plan, spec, round_index, client_ids: torch.Tensor,
                 length: int, first: int = 0) -> torch.Tensor:
    """(..., length) garbage words at the corruption counter space, of the
    lanes or coordinates [first, first + length)."""
    coords = torch.arange(first, first + length, dtype=torch.int64,
                          device=client_ids.device)
    return hash_u32(plan.seed, spec.tensor_id, CORRUPT_CTR,
                    _round_word(round_index), client_ids[..., None], coords)


def corrupt_uploads(plan: FaultPlan, z_all, declared, corrupt_mask,
                    round_index, client_ids, zspecs, packed: bool,
                    offsets=None, total=None):
    """The uploads as the server receives them: each flagged client's
    payload damaged, so its checksum differs from ``declared``.

    ``z_all``: {path: upload} with an optional leading client axis, lanes
    (int64) when ``packed``, else f32 masks or probabilities;
    ``declared``: ``fault.validate.upload_counts`` of the clean uploads;
    ``corrupt_mask``: bool, shaped as the client axis (or 0-d).  On a
    model rank ``z_all`` holds slices: ``offsets`` {path: index of the
    slice's first lane (packed) or coordinate} and ``total(path, x)``
    the whole upload's sum of a slice's checksum ``x`` (``declared`` is
    whole already); only the slice holding index 0 flips it."""
    out = {}
    for path, spec in zspecs.specs.items():
        z = z_all[path]
        first_at = 0 if offsets is None else offsets[path]
        g = _garbage_u32(plan, spec, round_index,
                         _id_tensor(client_ids, z.device), z.shape[-1],
                         first_at)
        if packed:
            bad = z.to(torch.int64) ^ g
            count = packed_total_popcount(bad)
        else:
            # garbage bits for the payload; the f32 sum checksum is exact
            bad = (g >> 31).to(z.dtype)
            count = bad.sum(-1)
        if total is not None:
            count = total(path, count)
        clash = (count == declared[path]) & (first_at == 0)
        if packed:
            first = torch.where(clash, bad[..., 0] ^ 1, bad[..., 0])
        else:
            first = torch.where(clash, 1.0 - bad[..., 0], bad[..., 0])
        bad = torch.cat([first[..., None], bad[..., 1:]], dim=-1)
        mask = corrupt_mask[..., None] if z.ndim > 1 else corrupt_mask
        out[path] = torch.where(mask, bad, z)
    return out
