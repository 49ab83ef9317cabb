"""Feedforward classifiers of the paper's experiments, K clients at once.

The JAX package's ``models/mlp.py``: SMALL 784-20-20-10, MNISTFC
784-300-100-10 (266,610 parameters).  Parameters are a flat
``{"layer{i}/kernel": (in, out), "layer{i}/bias": (out,)}`` dict.  A
leading client axis on every leaf, ``(K, in, out)`` and ``(K, out)``
with inputs ``(K, B, in)``, runs the K clients' networks as
``torch.bmm`` — the products the JAX package leaves to XLA under
``vmap``.  Initial parameters come from numpy (``dense_init`` draws
from ``jax.random``, which has no torch twin).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..core.zampling import LeafSpec

SMALL_DIMS = (784, 20, 20, 10)
MNISTFC_DIMS = (784, 300, 100, 10)


def param_count(dims: Sequence[int]) -> int:
    return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


def mlp_template(dims: Sequence[int]) -> Dict[str, LeafSpec]:
    """Parameter shapes of an MLP, keyed as the JAX package's tree."""
    tmpl = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        tmpl[f"layer{i}/kernel"] = LeafSpec((a, b))
        tmpl[f"layer{i}/bias"] = LeafSpec((b,))
    return tmpl


def mlp_forward(params: Dict[str, torch.Tensor], x: torch.Tensor):
    """Logits; a leading client axis on the parameters batches the K
    networks as ``bmm`` over ``x`` (K, B, in)."""
    n = sum(1 for k in params if k.endswith("/kernel"))
    for i in range(n):
        w, b = params[f"layer{i}/kernel"], params[f"layer{i}/bias"]
        if w.ndim == 3:
            x = torch.bmm(x, w) + b[:, None, :]
        else:
            x = x @ w + b
        if i < n - 1:
            x = torch.relu(x)
    return x


def mlp_loss(params, batch) -> torch.Tensor:
    """Mean cross-entropy: a scalar, or (K,) per client when batched."""
    logits = mlp_forward(params, batch["x"])
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    picked = torch.gather(logp, -1, batch["y"].to(torch.int64)[..., None])
    return -picked[..., 0].mean(-1)


def mlp_accuracy(params, batch) -> torch.Tensor:
    logits = mlp_forward(params, batch["x"])
    return (logits.argmax(-1) == batch["y"]).to(torch.float32).mean(-1)
