"""Uplink transports: the wire format of the clients' mask uploads.

The JAX package's ``comm/protocol.py``, the stacked (one-host) forms of
``mean_f32`` (f32 {0,1} masks, 32 bits a coordinate; alias ``mean``)
and ``psum_u32`` (bit-packed lanes, the server sums per-coordinate
vote counts).  Both give the same bits: the counts are exact integers
in either form, and the mean is ``counts * (1/K)`` in float32.

That reciprocal is the JAX package's arithmetic as it runs: under
``jax.jit`` XLA rewrites ``counts / K`` (K static) into a multiply by
``1/K``, which differs from a true division by an ulp at some counts
(K = 10: count 9; none at K = 3); ``jnp.mean`` multiplies by ``1/K``
even outside ``jit``.  ``mean0`` is that mean for the dense leaves: a
sequential sum over the client axis, then ``* (1/K)``, in float32 for
the bf16 leaves of a full-width LM, as ``jnp.mean`` takes it.

The collective forms serve the sharded round, one client per rank of
a ``torch.distributed`` group (``comm.shardmap``): each rank holds its
own upload and every rank gets the same mean.  ``mean_f32`` all-reduces
the f32 masks; ``psum_u32`` unpacks its lanes to per-coordinate bits
and all-reduces the int32 counts (the JAX package's operand; torch
cannot reduce uint32).  The sums are exact integers in any reduction
order, and both end in the same ``* (1/K)``, so a collective mean
equals the stacked mean of the same K uploads bit for bit.

``allgather_packed`` comes with a later slice.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from .bitpack import pack_mask, packed_len, packed_popcount_sum, unpack_mask
from .shardmap import axis_size


def recip_f32(k: int) -> float:
    """float32(1) / float32(k), as a Python float (exactly that f32)."""
    return float(np.float32(1.0) / np.float32(k))


def mean0(x: torch.Tensor) -> torch.Tensor:
    """Mean over the leading (client) axis as ``jnp.mean(x, axis=0)``
    computes it: ascending sum, then a multiply by ``1/K``, in float32
    for a bf16 or f16 ``x`` (``jnp.mean`` upcasts those), cast back."""
    acc = x[0].to(torch.float32)
    for k in range(1, x.shape[0]):
        acc = acc + x[k]
    return (acc * recip_f32(x.shape[0])).to(x.dtype)


class Transport:
    """One uplink wire format."""

    name: str = "?"
    packed_wire: bool = False  # True: the native operand is uint32 lanes

    def uplink_bits_per_client(self, n: int) -> int:
        raise NotImplementedError

    def aggregate_stacked(self, Z: torch.Tensor) -> torch.Tensor:
        """(K, n) f32 masks -> (n,) f32 mean."""
        raise NotImplementedError

    def aggregate_stacked_packed(self, lanes: torch.Tensor, n: int):
        """(K, L) lanes -> (n,) f32 mean."""
        raise NotImplementedError(
            f"transport {self.name!r} does not take packed lanes")

    def aggregate_collective(self, z: torch.Tensor, group=None):
        """This rank's (n,) f32 mask -> the (n,) f32 mean over the
        group's ranks."""
        raise NotImplementedError

    def aggregate_collective_packed(self, lanes: torch.Tensor, n: int,
                                    group=None):
        """This rank's (L,) lanes -> the (n,) f32 mean over the group."""
        raise NotImplementedError(
            f"transport {self.name!r} does not take packed lanes")


def _counts_mean(counts: torch.Tensor, k: int) -> torch.Tensor:
    return counts.to(torch.float32) * recip_f32(k)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``mean0``'s collective form, the mean of ``x`` over the group's
    ranks as the JAX package's sharded round takes a dense leaf's: an
    f32 all-reduce, then ``* (1/K)``, cast back to ``x``'s dtype."""
    s = x.to(torch.float32).clone()
    dist.all_reduce(s, group=group)
    return (s * recip_f32(axis_size(group))).to(x.dtype)


class MeanF32(Transport):
    """Baseline: f32 masks, 32 bits a coordinate."""

    name = "mean_f32"

    def uplink_bits_per_client(self, n: int) -> int:
        return 32 * n

    def aggregate_stacked(self, Z):
        # a sum of {0,1} values is exact in any order
        return _counts_mean(Z.to(torch.float32).sum(0), Z.shape[0])

    def aggregate_collective(self, z, group=None):
        return pmean(z.to(torch.float32), group)


class PsumU32(Transport):
    """Bit-packed lanes; the server sums the per-coordinate bits."""

    name = "psum_u32"
    packed_wire = True

    def uplink_bits_per_client(self, n: int) -> int:
        return 32 * packed_len(n)

    def aggregate_stacked_packed(self, lanes, n):
        return _counts_mean(packed_popcount_sum(lanes, n), lanes.shape[0])

    def aggregate_collective(self, z, group=None):
        return self.aggregate_collective_packed(pack_mask(z), z.shape[-1],
                                                group)

    def aggregate_collective_packed(self, lanes, n, group=None):
        counts = unpack_mask(lanes, n, dtype=torch.int32)  # a new tensor
        dist.all_reduce(counts, group=group)
        return _counts_mean(counts, axis_size(group))


_REGISTRY: Dict[str, Transport] = {t.name: t for t in (MeanF32(), PsumU32())}
_ALIASES = {"mean": "mean_f32"}
_LATER = ("allgather_packed",)


def transport_names(include_aliases: bool = True) -> List[str]:
    names = sorted(_REGISTRY)
    return names + sorted(_ALIASES) if include_aliases else names


def get_transport(name: str) -> Transport:
    canonical = _ALIASES.get(name, name)
    if canonical in _LATER:
        raise NotImplementedError(
            f"transport {name!r} is not ported yet; the port has "
            f"{', '.join(transport_names())}")
    if canonical not in _REGISTRY:
        raise ValueError(f"unknown transport {name!r}; registered: "
                         f"{', '.join(transport_names())}")
    return _REGISTRY[canonical]


def resolve_transport(aggregate: str, mode: str = "sample") -> Transport:
    """The round's transport; continuous (probability) uploads cannot
    be bit-packed and take ``mean_f32``."""
    if mode == "continuous":
        return get_transport("mean_f32")
    return get_transport(aggregate)
