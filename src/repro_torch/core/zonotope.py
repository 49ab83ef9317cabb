"""Convex-random-geometry quantities of the paper's §2, as in the JAX
package's ``core/zonotope.py``:

- Lemma 2.2: E[#nonzero entries of w = Q z] = m (1 - 2^-d);
- Lemma 2.3: the empty-column fraction, ~ e^-d;
- Prop. 2.4: max_p E|Q_i p| = Theta(sqrt(d / fan_in));
- Prop. 2.5: E[vol_n(Z_Q)], in log space (it under- and overflows in
  linear space already at n ~ 50);
- Def. 2.2 / Prop. 2.6: the tau-hypercube dimension, and the Gaussian
  impulse on the non-trivial coordinates that Table 4 measures.

The JAX package draws the impulse's noise from a PRNG key; here it is
given, as a tensor of N(0, 1) draws or a ``torch.Generator`` on the
scores' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def expected_nonzero_weights(m: int, d: int) -> float:
    """Lemma 2.2 (at p ~ U(0, 1): P(all d mask bits zero) = 2^-d)."""
    return m * (1.0 - 0.5 ** d)


def empty_column_fraction(d: int) -> float:
    """Lemma 2.3's limit: the fraction of all-zero columns for large
    m = n."""
    return math.exp(-d)


def expected_empty_columns(m: int, n: int, d: int) -> float:
    """E[#empty columns] = n (1 - d/n)^m (App. C)."""
    return n * (1.0 - d / n) ** m


def max_row_magnitude(d: int, fan_in: int) -> float:
    """Prop. 2.4's upper bound d sigma sqrt(2/pi), sigma = sqrt(6/(d f))."""
    sigma = math.sqrt(6.0 / (d * fan_in))
    return d * sigma * math.sqrt(2.0 / math.pi)


def log_expected_zonotope_volume(fan_ins, d: int) -> float:
    """Prop. 2.5 in log space:

    log E[vol_n(Z_Q)] = log n! + (n/2) log(3/d) - log Gamma(1 + n/2)
                        - (1/2) sum_i log fan_in_i
    """
    n = len(fan_ins)
    return (
        math.lgamma(n + 1)
        + 0.5 * n * math.log(3.0 / d)
        - math.lgamma(1.0 + n / 2.0)
        - 0.5 * float(sum(math.log(f) for f in fan_ins))
    )


def tau_hypercube_dim(p, tau: float) -> int:
    """dim(C_tau) = #{j : tau <= p_j <= 1 - tau} (Def. 2.2); ``p`` a
    tensor or a numpy array, compared in its own dtype."""
    if isinstance(p, torch.Tensor):
        return int(((p >= tau) & (p <= 1.0 - tau)).sum())
    p = np.asarray(p)
    return int(np.sum((p >= tau) & (p <= 1.0 - tau)))


def perturb_nontrivial(p: torch.Tensor, noise, tau: float,
                       scale: float = 1.0):
    """Gaussian impulse on the non-trivial coordinates (paper §3.3).

    ``noise``: N(0, 1) draws of ``p``'s shape (a tensor), or a
    ``torch.Generator`` on ``p``'s device to draw them from.  Returns
    (p + eps * mask, eps * mask) with eps = noise * scale in float32.
    tau >= 0.5 perturbs every coordinate: the paper's Table 4 reads the
    degenerate single-point C_0.5 as the everything-perturbed stress
    test."""
    if isinstance(noise, torch.Generator):
        noise = torch.randn(p.shape, generator=noise, dtype=torch.float32,
                            device=p.device)
    if tau >= 0.5:
        mask = torch.ones_like(p)
    else:
        mask = ((p >= tau) & (p <= 1.0 - tau)).to(torch.float32)
    eps = noise.to(device=p.device, dtype=torch.float32) * scale
    return p + eps * mask, eps * mask
