"""Evaluation of sampled networks (the paper's "sampled accuracy").

The JAX package's ``train/local.py`` ``evaluate``.  It draws network i
at ``jax.random.fold_in(key, i)``, which has no torch twin, so the
port takes one draw word per sampled network.  Local training
(``train_local_zampling``, Adam) comes with a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from ..core.zampling import ZamplingSpecs, sample_weights


def evaluate(zspecs: ZamplingSpecs, state: Dict[str, Any],
             metric_fn: Callable, words: Sequence[int], *,
             mode: str = "sample", carried: Optional[str] = None,
             impl: Optional[str] = None, device="cuda"):
    """(mean, std) of ``metric_fn(params)`` over one sampled network per
    draw word.  ``carried`` names the codec of an encoded score state;
    a u8/u16 carry is drawn from straight, in the kernel."""
    if mode != "sample":
        raise NotImplementedError(
            f"evaluate mode={mode!r}: the expected and discretized "
            "networks come with a later slice")
    vals = [float(metric_fn(sample_weights(zspecs, state, w, carried=carried,
                                           impl=impl, device=device)))
            for w in words]
    return float(np.mean(vals)), float(np.std(vals))
