"""Hot-block tile cache: the budgeted midpoint of the load/stream trade
(the JAX package's ``serve/cache.py``).

``mode="load"`` holds 32 bits a weight, ``mode="streaming"`` only the
encoded words.  The cache is a dial between them: a byte-budgeted pool
of materialized f32 tiles, one pool row per canonical contraction block
(key (path, group, block); ``kernels/ops.py``'s serve half).  Budget 0
is streaming; a budget of at least 4 m bytes of the matmul leaves holds
every tile; between, the first ``budget // (4 bm)`` tiles in canonical
order serve from the pool and the rest stream.  A pool row is written
by ``ops.serve_fill_tiles`` with the values the streaming path
regenerates, and ``ops.serve_cached_matmul`` walks the same canonical
tree, so every occupancy gives the streaming bits.

The pool is a (max(capacity, 1), bm) float32 tensor on the state's
device; the slot maps, owners, clock hand and reference bits are host
numpy, as in the JAX package, and the engine reads a device snapshot
(``arrays()``).  Hits and misses are counted analytically per step
(``record_step``): a decode step contracts every block of every
cacheable leaf once.

The bookkeeping gives JAX's slot map, owners, clock hand, reference
bits and counters for the same sequence of calls.  JAX's ``fill`` takes
the lowest free slot for each uncached block in canonical order, one
scan of the pool per tile; here the free slots, ascending, go to the
uncached blocks in canonical order in one vectorized step, which is
the same assignment (the free set only shrinks until it is empty).
Only after that does a fill with ``evict=True`` run the clock, one
block at a time, as JAX does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..kernels import ops
from .state import ServeState

FILL_CHUNK = 1 << 18  # tiles a fill launch writes at most (256 MiB)


@dataclass(frozen=True)
class ServeConfig:
    """Operator-facing serving knobs: ``lanes`` (fixed batch width of
    the scheduler), ``seq_len`` (per-lane KV capacity),
    ``cache_budget_bytes`` (hot-block pool budget, the load/stream
    dial), ``mode`` ('cached' engages the pool), ``impl`` (serve impl
    override) and ``max_new_tokens``."""

    lanes: int = 4
    seq_len: int = 128
    cache_budget_bytes: int = 0
    mode: str = "cached"
    impl: Optional[str] = None
    max_new_tokens: int = 32

    def __post_init__(self):
        if self.lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {self.lanes}")
        if self.seq_len < 1:
            raise ValueError(f"seq_len must be >= 1, got {self.seq_len}")
        if self.cache_budget_bytes < 0:
            raise ValueError(f"cache_budget_bytes must be >= 0, got "
                             f"{self.cache_budget_bytes}")
        if self.mode not in ("load", "streaming", "cached"):
            raise ValueError(f"unknown serve mode {self.mode!r}")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{self.max_new_tokens}")


@dataclass
class _LeafGrid:
    """Canonical-block geometry of one cacheable leaf."""

    spec: Any
    groups: int
    nblk: int  # canonical blocks per group
    bpw: int  # blocks per window
    w0: np.ndarray  # (groups,) first window of each group


class HotBlockCache:
    """Host-side manager of the (pool, slot-map) tile cache.  Mutable:
    fills, evictions and invalidations rewrite the slot maps and the
    pool rows in place.  One scheduler owns one cache."""

    def __init__(self, sstate: ServeState, budget_bytes: int, *,
                 bm: int = ops.SERVE_BM):
        self.bm = int(bm)
        self.tile_bytes = 4 * self.bm
        self.budget_bytes = int(budget_bytes)
        self.qbits = sstate.qbits
        self.qpacked = sstate.qpacked
        # every zampled matmul leaf; 'embed' streams through the row
        # gather, which runs no blocked contraction
        self.grids: Dict[str, _LeafGrid] = {}
        for path in sorted(sstate.zspecs.specs):
            if path == "embed":
                continue
            spec = sstate.zspecs.specs[path]
            groups, d_in, d_out = ops.serve_group_dims(spec)
            sub = d_in * d_out
            _, nblk, bpw = ops.serve_block_grid(spec, self.bm, 0, sub)
            w0 = np.empty(groups, np.int64)
            for g in range(groups):
                w0[g], nb, _ = ops.serve_block_grid(spec, self.bm, g * sub,
                                                    sub)
                if nb != nblk:
                    raise ValueError(f"{path}: group {g} has {nb} canonical "
                                     f"blocks, group 0 {nblk}")
            self.grids[path] = _LeafGrid(spec=spec, groups=groups, nblk=nblk,
                                         bpw=bpw, w0=w0)
        self.total_tiles = sum(g.groups * g.nblk for g in self.grids.values())
        # a budget past the model buys one row per canonical tile
        self.capacity = min(self.budget_bytes // self.tile_bytes,
                            self.total_tiles)
        # at least one row, so a launch always has a pool to point at
        rows = max(self.capacity, 1)
        self.pool = torch.zeros((rows, self.bm), dtype=torch.float32,
                                device=sstate.device)
        self.slots: Dict[str, np.ndarray] = {
            p: np.full((g.groups, g.nblk), -1, np.int32)
            for p, g in self.grids.items()}
        # slot k's owner as (path index, group, block); -1 = free
        self._paths: List[str] = list(self.grids)
        self._owner = np.full((rows, 3), -1, np.int64)
        self._ref = np.zeros(rows, bool)
        self._hand = 0
        self.counters = {"hits": 0, "misses": 0, "fills": 0,
                         "evictions": 0, "invalidations": 0}
        self._device_slots: Optional[Dict[str, torch.Tensor]] = None

    # --- accounting -------------------------------------------------------
    @property
    def resident_tiles(self) -> int:
        return int((self._owner[:self.capacity, 0] >= 0).sum())

    @property
    def capacity_bytes(self) -> int:
        """Allocated pool bytes (what the budget buys)."""
        return self.capacity * self.tile_bytes

    @property
    def used_bytes(self) -> int:
        return self.resident_tiles * self.tile_bytes

    def stats(self) -> Dict[str, Any]:
        return {**self.counters, "resident_tiles": self.resident_tiles,
                "total_tiles": self.total_tiles,
                "capacity_tiles": self.capacity,
                "capacity_bytes": self.capacity_bytes,
                "used_bytes": self.used_bytes}

    def record_step(self, n_steps: int = 1) -> None:
        """Hits and misses of ``n_steps`` engine steps (every resident
        tile hits once a step, every other block misses), and the
        clock's touch: every resident tile's reference bit is set."""
        r = self.resident_tiles
        self.counters["hits"] += r * n_steps
        self.counters["misses"] += (self.total_tiles - r) * n_steps
        self._ref[self._owner[:, 0] >= 0] = True

    # --- slot allocation (clock) -----------------------------------------
    def _evict_clock(self) -> int:
        """Second-chance clock: clear reference bits until an
        unreferenced resident slot comes under the hand; evict it."""
        for _ in range(2 * self.capacity + 1):
            k = self._hand
            self._hand = (self._hand + 1) % self.capacity
            if self._owner[k, 0] < 0:
                continue
            if self._ref[k]:
                self._ref[k] = False
                continue
            pi, g, t = self._owner[k]
            self.slots[self._paths[pi]][g, t] = -1
            self._owner[k] = -1
            self.counters["evictions"] += 1
            self._device_slots = None
            return k
        raise RuntimeError("clock found no evictable slot")

    # --- fill -------------------------------------------------------------
    def _uncached_blocks(self) -> np.ndarray:
        """(N, 3) (path index, group, block) of every uncached block, in
        canonical order."""
        parts = [np.zeros((0, 3), np.int64)]
        for pi, path in enumerate(self._paths):
            g, t = np.nonzero(self.slots[path] < 0)
            parts.append(np.stack([np.full_like(g, pi), g, t], 1))
        return np.concatenate(parts).astype(np.int64)

    def fill(self, sstate: ServeState, *, limit: Optional[int] = None,
             evict: bool = False) -> int:
        """Materialize uncached tiles into the pool, in canonical order.

        Fills free slots only by default (the dense decode pattern
        touches every resident tile every step, so evicting to admit a
        tile would thrash); ``evict=True`` lets the clock make room.
        Returns the tiles filled.  Each leaf's tiles go through
        ``ops.serve_fill_tiles`` in chunks of at most ``FILL_CHUNK``."""
        if self.capacity == 0:
            return 0
        want = self._uncached_blocks()
        if limit is not None:
            want = want[:limit]
        free = np.nonzero(self._owner[:self.capacity, 0] < 0)[0]
        k = min(len(want), len(free))
        self._assign(want[:k], free[:k])
        touched = [free[:k]]
        filled = k
        if evict:
            for w in want[k:]:
                slot = np.asarray([self._evict_clock()])
                self._assign(w[None], slot)
                touched.append(slot)
                filled += 1
        if not filled:
            return 0
        # each slot written once, with the block that holds it now (a
        # block filled and then evicted within this call leaves none)
        ks = np.unique(np.concatenate(touched))
        owners = self._owner[ks]
        dev = self.pool.device
        for pi, path in enumerate(self._paths):
            sel = owners[:, 0] == pi
            if not sel.any():
                continue
            g, t, kp = owners[sel, 1], owners[sel, 2], ks[sel]
            grid = self.grids[path]
            for i0 in range(0, len(kp), FILL_CHUNK):
                i1 = i0 + FILL_CHUNK
                tiles = ops.serve_fill_tiles(
                    grid.spec, sstate.words[path], sstate.step,
                    torch.from_numpy(g[i0:i1]), torch.from_numpy(t[i0:i1]),
                    qbits=self.qbits, qpacked=self.qpacked, bm=self.bm)
                self.pool[torch.from_numpy(kp[i0:i1]).to(dev)] = tiles
        self.counters["fills"] += filled
        self._device_slots = None
        return filled

    def _assign(self, blocks: np.ndarray, slots: np.ndarray) -> None:
        """Blocks (N, 3) take slots (N,), referenced."""
        self._owner[slots] = blocks
        self._ref[slots] = True
        for pi, path in enumerate(self._paths):
            sel = blocks[:, 0] == pi
            if sel.any():
                self.slots[path][blocks[sel, 1], blocks[sel, 2]] = slots[sel]

    # --- invalidation -----------------------------------------------------
    def invalidate_windows(self, path: str, flipped) -> int:
        """Drop every tile of ``path`` whose window's drawn bits flipped.
        ``flipped``: (num_windows,) bool.  A canonical block reads the
        coordinates of one window (w0[g] + t // bpw), so window
        granularity is tile granularity.  Returns the tiles dropped."""
        grid = self.grids.get(path)
        if grid is None:
            return 0
        if isinstance(flipped, torch.Tensor):
            flipped = flipped.cpu().numpy()
        flipped = np.asarray(flipped, bool)
        t = np.arange(grid.nblk)
        win = grid.w0[:, None] + t[None, :] // grid.bpw  # (groups, nblk)
        kill = flipped[win] & (self.slots[path] >= 0)
        n = int(kill.sum())
        if n:
            dead = self.slots[path][kill]
            self._owner[dead] = -1
            self._ref[dead] = False
            self.slots[path][kill] = -1
            self.counters["invalidations"] += n
            self._device_slots = None
        return n

    def invalidate_all(self) -> int:
        """Full drop (a codec, draw word or leaf set change)."""
        n = self.resident_tiles
        for path in self._paths:
            self.slots[path][:] = -1
        self._owner[:] = -1
        self._ref[:] = False
        if n:
            self.counters["invalidations"] += n
            self._device_slots = None
        return n

    # --- the engine's snapshot --------------------------------------------
    def arrays(self) -> Dict[str, Any]:
        """{"pool": (S, bm) f32, "slots": {path: (groups, nblk) int32}}
        on the pool's device."""
        if self._device_slots is None:
            self._device_slots = {
                p: torch.from_numpy(s.copy()).to(self.pool.device)
                for p, s in self.slots.items()}
        return {"pool": self.pool, "slots": self._device_slots}


def build_cache(sstate: ServeState, config: ServeConfig, *,
                warm: bool = True) -> HotBlockCache:
    """The hot-block cache of a serving node at the config's budget,
    warmed by default: the first ``budget // (4 bm)`` canonical tiles
    (first touch under the dense decode pattern is canonical order)."""
    cache = HotBlockCache(sstate, config.cache_budget_bytes)
    if warm:
        cache.fill(sstate)
    return cache
