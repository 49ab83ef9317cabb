"""Ranks of a ``torch.distributed`` process group: the client axis.

The JAX package runs the sharded round's body under ``shard_map``
(``comm/shardmap.py``), one client per device along a mesh axis:
``axis_size`` counts the axis's devices and ``jax.lax.axis_index`` names
this one.  In the port a client is a rank of a process group:
``axis_size(group)`` is the group's world size and ``axis_index(group)``
its rank.

``run_ranks`` takes the place of ``shard_map_compat``: it runs a
top-level function on ``world`` ranks and returns each rank's result.
Each rank is a process started by ``spawn`` (CUDA does not survive a
fork), joins the group through a ``FileStore`` in a temporary directory
(so runs side by side never race for a TCP port) with a timeout on
every collective, and leaves it with ``destroy_process_group``.  A rank
that raises, dies or outlasts the timeout makes ``run_ranks`` raise,
and every rank still running is terminated.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import torch.distributed as dist

_GRACE = 2.0  # seconds to gather the other ranks' reports after a failure


def axis_size(group=None) -> int:
    """Clients on the axis: the group's world size."""
    return dist.get_world_size(group)


def axis_index(group=None) -> int:
    """This client's position on the axis: its rank in the group."""
    return dist.get_rank(group)


def _rank_main(call_path: str, rank: int, world: int, store_path: str,
               backend: str, timeout: float, results) -> None:
    """One rank: join the group, run the pickled ``fn(*args)``, report
    (rank, ok, pickled result or traceback)."""
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=timeout))
        try:
            out = (rank, True, pickle.dumps(fn(*args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # the parent raises it, with this traceback
        out = (rank, False, traceback.format_exc())
    results.put(out)


def _stop(procs) -> None:
    procs = [p for p in procs if p.pid is not None]  # the started ones
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join(timeout=10)


def run_ranks(fn: Callable[..., Any], world: int, args: Sequence[Any] = (),
              *, backend: str = "gloo", timeout: float = 600.0,
              tmpdir: Optional[str] = None) -> List[Any]:
    """``fn(*args)`` on each of ``world`` ranks of a new process group;
    returns the ranks' results, rank 0 first.

    ``fn`` must be importable by name (a top-level function of a module
    the ranks can import) and return something that pickles; keep its
    tensors on the host.  ``timeout`` seconds bound each collective and
    the whole run.  The store's file lives in a new directory under
    ``tmpdir`` (the system's temporary directory by default).  Raises
    ``RuntimeError`` when a rank raises or exits without a result and
    ``TimeoutError`` when the run outlasts ``timeout``."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(dir=tmpdir) as d:
        # the call goes by file: spawn writes a process's arguments into
        # a pipe that a rank dying at start-up leaves full, blocking start()
        call = os.path.join(d, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        store = os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            call, rank, world, store, backend, timeout, results))
            for rank in range(world)]
        try:
            for p in procs:
                p.start()
            got, failed = {}, {}
            end = deadline
            while len(got) + len(failed) < world:
                left = end - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    failed.update({
                        r: f"exited with code {p.exitcode} without a result"
                        for r, p in enumerate(procs) if r not in got
                        and r not in failed and p.exitcode is not None})
                else:
                    if ok:
                        got[rank] = pickle.loads(payload)
                    else:
                        failed[rank] = payload
                if failed:  # a peer's report may name the first cause
                    end = min(end, time.monotonic() + _GRACE)
            if failed:
                raise RuntimeError("ranks failed:\n" + "\n".join(
                    f"rank {r} of {world}: {why}"
                    for r, why in sorted(failed.items())))
            if len(got) < world:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world)) - set(got))} gave no "
                    f"result within {timeout} s")
            for p in procs:  # the queue is drained: each rank is exiting
                p.join(timeout=max(1.0, deadline - time.monotonic()))
            return [got[r] for r in range(world)]
        finally:
            _stop(procs)
