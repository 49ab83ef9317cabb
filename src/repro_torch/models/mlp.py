"""Feedforward classifiers of the paper's experiments, K clients at once.

The JAX package's ``models/mlp.py``: SMALL 784-20-20-10, MNISTFC
784-300-100-10 (266,610 parameters).  Parameters are a flat
``{"layer{i}/kernel": (in, out), "layer{i}/bias": (out,)}`` dict.  A
leading client axis on every leaf, ``(K, in, out)`` and ``(K, out)``
with inputs ``(K, B, in)``, runs the K clients' networks as
``torch.bmm`` — the products the JAX package leaves to XLA under
``vmap``.  Initial parameters come from numpy (``init_mlp_params``; the
JAX package's ``dense_init`` draws from ``jax.random``, which has no
torch twin).

On a model axis a sharded kernel arrives as this rank's
``comm.shardmap.Block`` and ``models.common.project`` consumes it: a
column block's output columns are gathered (the next layer reads the
whole row), a row block takes its rows of the input and the partial
products meet in one all-reduce; the bias, a dense leaf, adds to the
whole output.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..core.zampling import LeafSpec
from .common import project

SMALL_DIMS = (784, 20, 20, 10)
MNISTFC_DIMS = (784, 300, 100, 10)


def param_count(dims: Sequence[int]) -> int:
    return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


def init_mlp_params(rng: np.random.RandomState,
                    dims: Sequence[int]) -> Dict[str, np.ndarray]:
    """Initial parameters as float32 numpy arrays: each kernel He-normal
    (std sqrt(2 / in), the JAX package's ``dense_init``) drawn from
    ``rng`` layer by layer, each bias zero."""
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"layer{i}/kernel"] = (rng.randn(a, b)
                                      * (2.0 / a) ** 0.5).astype(np.float32)
        params[f"layer{i}/bias"] = np.zeros((b,), np.float32)
    return params


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
        x = project(x, w) + (b[:, None, :] if b.ndim == 2 else b)
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
