"""Serving configuration (the JAX package's ``serve/cache.py``).

Only ``ServeConfig`` is ported so far: the hot-block tile cache
(``HotBlockCache``) comes with the load/cached slice, and
``mode="cached"`` raises until then.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ServeConfig:
    """Operator-facing serving knobs: ``lanes`` (fixed batch width of
    the scheduler), ``seq_len`` (per-lane KV capacity),
    ``cache_budget_bytes`` (hot-block pool budget), ``mode``,
    ``impl`` (serve impl override) and ``max_new_tokens``."""

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
