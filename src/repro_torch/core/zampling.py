"""Zampling over a model's parameter template: which leaves get a QSpec.

``build_specs`` walks a template of parameter shapes and gives every
large (>= 2-D, >= ``min_size`` weights) leaf a QSpec; the rest stay
dense.  A leaf's ``tensor_id`` is its index in the JAX package's
tree-flatten order, which sorts dict keys at every level: the id keys
every hash stream, so the port must number leaves in that same order.

Scores come in from outside (numpy arrays, a JAX state through
``repro_torch.convert``); the JAX package's ``init_state`` draws them
with ``jax.random``, which has no torch twin.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterator, NamedTuple, Tuple

from .qspec import QSpec, make_qspec


class LeafSpec(NamedTuple):
    """Shape and dtype name of one parameter leaf."""

    shape: tuple
    dtype: str = "float32"


@dataclass(frozen=True)
class ZamplingConfig:
    """Reparametrization hyper-parameters (the JAX package's fields)."""

    compression: float = 32.0  # m/n
    d: int = 8  # non-zeros per row of Q
    window: int = 512  # z-window size
    seed: int = 0  # shared seed for Q
    min_size: int = 1024  # leaves smaller than this stay dense
    mode: str = "sample"
    chunks: int = 1
    shard_align: int = 1


@dataclass(frozen=True)
class ZamplingSpecs:
    """Static spec set for one model."""

    specs: Dict[str, QSpec]
    dense_paths: Tuple[str, ...]
    template: Dict[str, LeafSpec]  # flat {path: LeafSpec}, flatten order
    config: ZamplingConfig

    @property
    def m_total(self) -> int:
        return sum(s.m for s in self.specs.values())

    @property
    def n_total(self) -> int:
        return sum(s.n for s in self.specs.values())


def _as_leaf(leaf) -> LeafSpec:
    if isinstance(leaf, LeafSpec):
        return leaf
    if hasattr(leaf, "shape"):
        return LeafSpec(tuple(int(s) for s in leaf.shape),
                        str(getattr(leaf, "dtype", "float32")))
    return LeafSpec(tuple(int(s) for s in leaf))


def _nest(flat: Dict[str, object]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return tree


def flatten(tree: dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) pairs in the JAX tree-flatten order of a dict tree:
    keys sorted at every level.  A flat ``{"a/b": leaf}`` dict is
    nested first, so both spellings give the same order."""
    if any("/" in k for k in tree):
        tree = _nest(tree)
    for key in sorted(tree):
        node = tree[key]
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(node, dict):
            yield from flatten(node, path)
        else:
            yield path, node


def default_fan_in(path: str, shape) -> int:
    """Fan-in of the target neuron: the product of all-but-last dims;
    embedding tables use the model dim."""
    if len(shape) < 2:
        return max(int(shape[0]) if shape else 1, 1)
    if "embed" in path.lower():
        return int(shape[-1])
    fan = 1
    for s in shape[:-1]:
        fan *= int(s)
    return max(fan, 1)


def build_specs(template: dict, config: ZamplingConfig,
                fan_in_fn: Callable[[str, tuple], int] = default_fan_in
                ) -> ZamplingSpecs:
    """Assign a QSpec to every large leaf of a shape template.

    ``template``: nested or flat (``"a/b"`` paths) dict whose leaves
    are shapes, ``LeafSpec``s, or anything with ``.shape``.
    """
    specs: Dict[str, QSpec] = {}
    dense = []
    flat: Dict[str, LeafSpec] = {}
    for tid, (path, leaf) in enumerate(flatten(template)):
        leaf = _as_leaf(leaf)
        flat[path] = leaf
        m = 1
        for s in leaf.shape:
            m *= int(s)
        if len(leaf.shape) >= 2 and m >= config.min_size:
            specs[path] = make_qspec(
                tid, leaf.shape, fan_in_fn(path, leaf.shape),
                compression=config.compression, d=config.d,
                window=config.window, seed=config.seed,
                align=config.shard_align)
        else:
            dense.append(path)
    return ZamplingSpecs(specs=specs, dense_paths=tuple(dense),
                         template=flat, config=config)
