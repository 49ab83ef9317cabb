"""Helpers of the model-family tests (``test_torch_families*.py``): the
reduced configs beside the JAX package's, tree paths, seeded
parameters."""

import jax
import numpy as np

from repro.configs import registry as jreg
from repro.models.model import build_model as jbuild
from repro_torch.configs import get_arch
from repro_torch.core.zampling import flatten
from repro_torch.models.model import param_template

K = 2
ZC = dict(compression=8, d=8, min_size=4096)  # the JAX entry point's

_NORMS = ("ln", "ln1", "ln2", "ln3", "final_norm", "enc_norm", "norm",
          "q_norm", "k_norm", "D")


def _jflat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nest(flat):
    out = {}
    for p, v in flat.items():
        node = out
        *heads, last = p.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


_BUILT = {}


def _built(name):
    """(port cfg, JAX cfg, JAX model) at reduced() size."""
    if name not in _BUILT:
        jcfg = jreg.get_arch(name).reduced()
        _BUILT[name] = (get_arch(name).reduced(), jcfg, jbuild(jcfg))
    return _BUILT[name]


def _params(cfg, seed=0, k=K):
    """K clients' numpy parameters: norms near 1, weights small."""
    rng = np.random.RandomState(seed)
    out = {}
    for p, leaf in flatten(param_template(cfg)):
        norm = p.rsplit("/", 1)[-1] in _NORMS
        out[p] = (rng.randn(k, *leaf.shape) * (0.2 if norm else 0.05)
                  + (1.0 if norm else 0.0)).astype(np.float32)
    return out


def _rel_of_max(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
