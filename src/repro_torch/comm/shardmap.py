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

On a mesh (``launch.mesh.Mesh``, ``run_ranks(..., mesh=)``) a rank also
has a place on each axis: an ``AxisGroup``, the axis's subgroup with its
size and the rank's index on it (``launch.mesh.mesh_axes`` makes them).
The model axis's ``AxisGroup`` is the ``row_sharding`` handle of the
reconstruction ops: a model rank reconstructs only its block of a
sharded leaf (``kernels.qz_sharded``).  The round hands the model that
block as a ``Block`` (the tensor, the dim the model axis splits, the
axis), and the model's partitioned consumers take it as it is, with
Megatron's four mappings between replicated and split activations:
``copy_to_model`` (identity forward, all-reduce backward: the input of
a column-parallel product), ``reduce_from_model`` (all-reduce forward,
identity backward: the output of a row-parallel product),
``gather_from_model`` and ``scatter_to_model`` (an activation's blocks
joined, or a replicated activation's block taken, each the other's
backward), and a fifth, ``sum_over_model`` (all-reduce both ways: a
partial sum that each rank then uses on its own block, such as a split
RMSNorm's sum of squares).  ``gather_major`` (``Block.whole``) hands
the model a whole leaf: the small leaves a consumer cannot use as a
block (norm scales, the SSM's conv taps).

Every collective here counts itself in ``COUNTS`` (calls and bytes by
kind; the bytes are the tensor a rank hands the collective: an
all-reduce's whole operand, an all-gather's own block), and each whole
leaf gather in ``GATHERED`` by leaf path; ``reset_counts`` zeroes both.
A CUDA tensor on a gloo group goes through the host; the copies are
exact, and every rank of a group receives the same bits.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from collections import Counter
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

_GRACE = 2.0  # seconds to gather the other ranks' reports after a failure


def axis_size(group=None) -> int:
    """Clients on the axis: the group's world size."""
    return dist.get_world_size(group)


def axis_index(group=None) -> int:
    """This client's position on the axis: its rank in the group."""
    return dist.get_rank(group)


@dataclass(frozen=True)
class AxisGroup:
    """This rank's place on one mesh axis: the axis's process group
    (None: the default group), its size and this rank's index on it.  A
    handle made by hand (``AxisGroup(None, ms, sid)``) stands for shard
    ``sid`` of ``ms`` in code that issues no collective."""

    group: Any
    size: int
    index: int

    def __post_init__(self):
        if not 0 <= self.index < self.size:
            raise ValueError(f"index {self.index} outside an axis of "
                             f"{self.size}")


COUNTS: Counter = Counter()  # {kind: calls, kind + "_bytes": bytes}
GATHERED: Counter = Counter()  # {leaf path: whole gathers}


def reset_counts() -> None:
    """Zero the collective counters and the gathered leaves."""
    COUNTS.clear()
    GATHERED.clear()


def _count(kind: str, x: torch.Tensor) -> None:
    COUNTS[kind] += 1
    COUNTS[kind + "_bytes"] += x.numel() * x.element_size()


def _via_host(x: torch.Tensor, axis: AxisGroup) -> bool:
    return x.is_cuda and dist.get_backend(axis.group) == "gloo"


def all_gather_cat(x: torch.Tensor, dim: int, axis: AxisGroup,
                   kind: str = "all_gather"):
    """The axis's tensors, each rank's ``x`` (the same shape on every
    rank), concatenated along ``dim`` in rank order, counted under
    ``kind``."""
    x = x.contiguous()
    _count(kind, x)
    host = _via_host(x, axis)
    src = x.cpu() if host else x
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    out = torch.cat(parts, dim)
    return out.to(x.device) if host else out


def all_reduce(x: torch.Tensor, axis: AxisGroup, op=None) -> torch.Tensor:
    """A new tensor: the axis's ``x`` reduced by ``op`` (a sum by
    default) in ``x``'s dtype (gloo reduces bf16 as it is)."""
    _count("all_reduce", x)
    host = _via_host(x, axis)
    out = x.detach().to("cpu" if host else x.device, copy=True).contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op,
                    group=axis.group)
    return out.to(x.device) if host else out


class _GatherMajor(torch.autograd.Function):
    """Forward: the model axis's blocks concatenated along ``dim``,
    gathered with ``dim`` moved to ``front``; backward: this rank's block
    of the cotangent, no reduction: every rank of the axis runs the same
    replicated forward from the gathered tensor, so each holds the whole
    cotangent already."""

    @staticmethod
    def forward(ctx, block, dim, axis, front, kind):
        ctx.dim, ctx.axis = dim, axis
        moved = all_gather_cat(block.movedim(dim, front), front, axis, kind)
        return moved.movedim(front, dim)

    @staticmethod
    def backward(ctx, g):
        size = g.shape[ctx.dim] // ctx.axis.size
        return (g.narrow(ctx.dim, ctx.axis.index * size, size).contiguous(),
                None, None, None, None)


def gather_major(block: torch.Tensor, dim: int, axis: AxisGroup,
                 front: int = 0, path: str = "") -> torch.Tensor:
    """A sharded leaf's whole tensor from this model rank's block along
    its major axis ``dim``: an all-gather of the blocks (never a sum of
    zero-padded blocks, which would turn -0 into +0), differentiable,
    counted in ``GATHERED`` under ``path``.
    The blocks travel with ``dim`` moved to ``front`` (0, or 1 past a
    client axis): a reconstructed block is a view of its rows in that
    moved order, so they travel without a copy, and the whole tensor
    comes back as the same view of the whole moved order, with the
    strides the unsharded op gives (a product reads them, and may round
    otherwise for other strides)."""
    GATHERED[path] += 1
    return _GatherMajor.apply(block, dim, axis, front, "leaf_gather")


@dataclass(frozen=True, eq=False)
class Block:
    """A model rank's block of a leaf: ``t`` holds the rows
    ``[index * b, (index + 1) * b)`` of dim ``dim`` of the whole tensor
    (``b = t.shape[dim]``), split over ``axis``; ``front`` leading
    client axes; ``path`` names the leaf.  The round makes it from the
    leaf's placement (its constraint, which names the spec's major
    axis); nothing reads a placement off a shape."""

    t: torch.Tensor
    dim: int
    axis: AxisGroup
    path: str = ""
    front: int = 0

    @property
    def cols(self) -> bool:
        """Split on the last axis: a column-parallel weight."""
        return self.dim == self.t.ndim - 1

    @property
    def rows(self) -> bool:
        """Split on the second-to-last axis: a row-parallel weight (an
        embedding table's vocabulary rows)."""
        return self.dim == self.t.ndim - 2

    def whole(self) -> torch.Tensor:
        """The whole leaf (``gather_major``)."""
        return gather_major(self.t, self.dim, self.axis, self.front,
                            self.path)

    def lead(self) -> "Block":
        """The block with a leading client axis of one."""
        return Block(self.t[None], self.dim + 1, self.axis, self.path,
                     self.front + 1)

    def unbind(self, dim: int):
        """Per-index blocks along an axis before the split one (a layer
        stack's)."""
        if dim >= self.dim:
            raise ValueError(f"{self.path!r}: unbinding dim {dim} of a "
                             f"block split on dim {self.dim}")
        return tuple(Block(t, self.dim - 1, self.axis, self.path,
                           self.front) for t in self.t.unbind(dim))


def whole(x):
    """A tensor as it is; a ``Block``'s whole leaf."""
    return x.whole() if isinstance(x, Block) else x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        size = x.shape[dim] // axis.size
        return x.narrow(dim, axis.index * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        d = ctx.dim % g.ndim
        return (all_gather_cat(g.movedim(d, 0), 0, ctx.axis).movedim(0, d),
                None, None)


def copy_to_model(x: torch.Tensor, axis: Optional[AxisGroup]
                  ) -> torch.Tensor:
    """A replicated activation entering column-parallel products: the
    same tensor, whose cotangent (each rank's part) is summed over the
    axis.  Here and in the helpers below, ``axis`` None (no model
    axis) gives ``x`` as it is."""
    return x if axis is None else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Optional[AxisGroup]
                      ) -> torch.Tensor:
    """The axis's partial results summed (a row-parallel product's), in
    ``x``'s dtype; the cotangent passes as it is."""
    return x if axis is None else _ReduceFromModel.apply(x, axis)


def sum_over_model(x: torch.Tensor, axis: Optional[AxisGroup]
                   ) -> torch.Tensor:
    """The axis's partial sums summed, for each rank to use on its own
    block: the cotangent differs by rank, so it is summed over the axis
    too (``reduce_from_model``'s identity backward holds only where what
    follows is replicated)."""
    return x if axis is None else _SumOverModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, dim: int,
                      axis: Optional[AxisGroup]) -> torch.Tensor:
    """An activation's blocks along ``dim`` joined in rank order (a
    contiguous tensor); the cotangent's block comes back."""
    if axis is None:
        return x
    d = dim % x.ndim
    return _GatherMajor.apply(x, d, axis, d, "all_gather").contiguous()


def scatter_to_model(x: torch.Tensor, dim: int,
                     axis: Optional[AxisGroup]) -> torch.Tensor:
    """This rank's block along ``dim`` of a replicated tensor; the
    cotangent's blocks are joined back."""
    return x if axis is None else _ScatterToModel.apply(x, dim, axis)


def max_over_model(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """The axis's elementwise maximum (no gradient)."""
    return all_reduce(x.detach(), axis, dist.ReduceOp.MAX)


def _rank_main(call_path: str, rank: int, world: int, store_path: str,
               backend: str, timeout: float, results, mesh=None) -> None:
    """One rank: join the group, run the pickled ``fn(*args)`` (with
    ``axes=`` its mesh axes on a mesh), report (rank, ok, pickled result
    or traceback)."""
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=timeout))
        try:
            if mesh is None:
                res = fn(*args)
            else:
                from ..launch.mesh import mesh_axes

                res = fn(*args, axes=mesh_axes(mesh))
            out = (rank, True, pickle.dumps(res))
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
              tmpdir: Optional[str] = None, mesh=None) -> List[Any]:
    """``fn(*args)`` on each of ``world`` ranks of a new process group;
    returns the ranks' results, rank 0 first.  With ``mesh`` (a
    ``launch.mesh.Mesh`` of ``world`` ranks) each rank calls
    ``fn(*args, axes=...)``, its ``launch.mesh.MeshAxes`` (its data and
    model subgroups).  ``backend`` is gloo (CPU tensors, or CUDA
    tensors moved through the host), or nccl with one rank a card.

    ``fn`` must be importable by name (a top-level function of a module
    the ranks can import) and return something that pickles; keep its
    tensors on the host.  ``timeout`` seconds bound each collective and
    the whole run.  The store's file lives in a new directory under
    ``tmpdir`` (the system's temporary directory by default).  Raises
    ``RuntimeError`` when a rank raises or exits without a result and
    ``TimeoutError`` when the run outlasts ``timeout``."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if mesh is not None and mesh.size != world:
        raise ValueError(f"a mesh of shape {mesh.shape} holds {mesh.size} "
                         f"ranks, not {world}")
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
            call, rank, world, store, backend, timeout, results, mesh))
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
