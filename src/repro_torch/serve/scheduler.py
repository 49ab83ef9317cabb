"""Continuous batching: a request scheduler over the serve engine step
(the JAX package's ``serve/scheduler.py``).

The engine's batched step runs as a fixed set of lanes: every step
advances all lanes one token, live-masked; a lane is admitted by
resetting its position to 0 (the previous occupant's KV sits beyond
the validity mask); a lane prefills decode-style, one prompt token per
step; it retires at ``max_new_tokens`` or its eos.  A lane's values
equal the single-request path's, so batching changes no output.

Sampling is greedy on the host: one device sync per step.  The hot
block cache and round deltas are not ported yet and raise.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.model import Model
from .cache import ServeConfig
from .decode import ServeEngine, build_serve_engine, check_mode
from .state import ServeState


@dataclass
class Request:
    """One queued or in-flight generation request."""

    rid: int
    prompt: np.ndarray  # (P,) int64
    max_new_tokens: int
    eos: Optional[int] = None
    tokens: List[int] = field(default_factory=list)
    fed: int = 0  # engine steps this request has taken


class ServeScheduler:
    """Fixed-lane continuous-batching driver for one serving node."""

    def __init__(self, model: Model, sstate: ServeState, config: ServeConfig,
                 *, cache=None, engine: Optional[ServeEngine] = None,
                 device="cuda"):
        check_mode(config.mode)
        if cache is not None:
            raise NotImplementedError(
                "the hot-block tile cache is not ported yet")
        self.device = resolve_device(device)
        self.config = config
        self.sstate = sstate
        self.engine = engine or build_serve_engine(
            model, sstate, mode=config.mode, impl=config.impl,
            device=device)
        self.cache = None
        self.arrays = self.engine.arrays_of(sstate)
        self.kv = self.engine.init_lane_cache(config.lanes, config.seq_len)
        self._lane: List[Optional[Request]] = [None] * config.lanes
        self._queue: deque = deque()
        self._next_rid = 0
        self.results: Dict[int, np.ndarray] = {}
        self.steps = 0

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos: Optional[int] = None) -> int:
        """Queue a request; returns its id (key into ``results``)."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        new = max_new_tokens or self.config.max_new_tokens
        if prompt.size + new > self.config.seq_len:
            raise ValueError(f"prompt ({prompt.size}) + max_new_tokens "
                             f"({new}) exceeds lane seq_len "
                             f"{self.config.seq_len}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid=rid, prompt=prompt,
                                   max_new_tokens=new, eos=eos))
        return rid

    @property
    def active(self) -> int:
        return sum(r is not None for r in self._lane)

    @property
    def pending(self) -> int:
        return len(self._queue) + self.active

    def _admit(self) -> None:
        for l in range(self.config.lanes):
            if self._lane[l] is None and self._queue:
                self._lane[l] = self._queue.popleft()
                pos = self.kv.pos.clone()
                pos[l] = 0
                self.kv = self.kv._replace(pos=pos)

    def _retire(self, l: int) -> None:
        req = self._lane[l]
        self.results[req.rid] = np.asarray(req.tokens, np.int64)
        self._lane[l] = None

    def step_once(self) -> None:
        """Admit, advance every live lane one token, sample, retire."""
        self._admit()
        B = self.config.lanes
        tok = np.zeros((B, 1), np.int64)
        live = np.zeros((B,), bool)
        for l, req in enumerate(self._lane):
            if req is None:
                continue
            live[l] = True
            tok[l, 0] = (req.prompt[req.fed] if req.fed < req.prompt.size
                         else req.tokens[-1])
        logits, self.kv = self.engine.step(
            self.arrays, self.kv, torch.from_numpy(tok).to(self.device),
            torch.from_numpy(live).to(self.device))
        self.steps += 1
        row = logits[:, 0].cpu().numpy()  # the per-step device sync
        for l, req in enumerate(self._lane):
            if req is None:
                continue
            req.fed += 1
            if req.fed >= req.prompt.size:
                nxt = int(np.argmax(row[l]))
                req.tokens.append(nxt)
                if len(req.tokens) >= req.max_new_tokens or nxt == req.eos:
                    self._retire(l)

    def run(self) -> Dict[int, np.ndarray]:
        """Step until every request retired; {rid: new tokens}."""
        while self.pending:
            self.step_once()
        return self.results

    def apply_round_delta(self, delta) -> ServeState:
        raise NotImplementedError(
            "XOR round deltas (serve/delta.py) are not ported yet")

    def metrics(self) -> Dict[str, Any]:
        return {"steps": self.steps, "lanes": self.config.lanes,
                "active": self.active, "queued": len(self._queue),
                "completed": len(self.results)}
