"""Meshes of ranks: the JAX package's ``launch/mesh.py``.

A JAX ``Mesh`` is a grid of devices with named axes; the port's is a
grid of ranks of a ``torch.distributed`` process group.  ``Mesh`` holds
only the axis names and the grid's shape, so building one touches no
device and no process group; the sharding rules (``launch.sharding``)
read nothing else.

Ranks lie on the grid row-major: with the data axes (``pod``, ``data``)
flattened into one data index, ``rank = data_index * model_size +
model_index``.  ``mesh_axes`` makes each rank's subgroups: its model
group (the ranks of its data index, which share a client and split its
sharded leaves) and its data group (the ranks of its model index, one a
client, whose uploads meet in the transport's collective).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch.distributed as dist

from ..comm.shardmap import AxisGroup

DATA_AXES = ("pod", "data")


@dataclass(frozen=True)
class Mesh:
    """A grid of ranks: ``shape[i]`` ranks along ``axis_names[i]``."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape) or min(self.shape) < 1:
            raise ValueError(f"mesh axes {self.axis_names} and shape "
                             f"{self.shape} do not match")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        """Ranks along ``name`` (1 for an axis the mesh lacks)."""
        return dict(zip(self.axis_names, self.shape)).get(name, 1)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh() -> Mesh:
    """The current process group as a (data, model) mesh of (world, 1);
    (1, 1) without one."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh(("data", "model"), (world, 1))


def data_axes(mesh: Mesh) -> tuple:
    """The client/batch axes: ('pod', 'data') when multi-pod."""
    return tuple(a for a in mesh.axis_names if a in DATA_AXES)


def data_size(mesh: Mesh) -> int:
    """Ranks along the data axes together: the clients of a round."""
    return math.prod(mesh.axis_size(a) for a in data_axes(mesh))


@dataclass(frozen=True)
class MeshAxes:
    """A rank's place on a mesh: its data axis (the data axes flattened)
    and its model axis."""

    data: AxisGroup
    model: AxisGroup


def mesh_axes(mesh: Mesh) -> MeshAxes:
    """This rank's data and model subgroups, inside a process group of
    ``mesh.size`` ranks.  Every rank makes every subgroup, in the same
    order (``new_group`` is collective over the whole group): the model
    groups by data index, then the data groups by model index."""
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"a mesh of shape {mesh.shape} needs {mesh.size} "
                         f"ranks; the process group has {world}")
    extra = set(mesh.axis_names) - set(DATA_AXES) - {"model"}
    if extra:
        raise ValueError(f"mesh axes {sorted(extra)} are neither data nor "
                         "model axes")
    rank = dist.get_rank()
    ms, dn = mesh.axis_size("model"), data_size(mesh)
    model_groups = [dist.new_group([d * ms + m for m in range(ms)])
                    for d in range(dn)]
    data_groups = [dist.new_group([d * ms + m for d in range(dn)])
                   for m in range(ms)]
    d, m = divmod(rank, ms)
    return MeshAxes(data=AxisGroup(data_groups[m], dn, d),
                    model=AxisGroup(model_groups[d], ms, m))
