"""Federated LM training in the port against the JAX package's, each
side carrying its own state over several rounds, on the same inputs.

JAX runs ``federated_round`` under ``jax.jit`` (as its
``launch/train.py`` does) on the CPU through its plain reference
(``impl="ref"``); the port runs the rounds of its LM entry point
(``repro_torch.launch.train``) on its plain torch path on the CPU.
Both take the inputs ``launch.train.build`` draws (scores U(0, 1) from
``RandomState(seed)``, the dense leaves of ``init_dense``, the round
words, the Markov token stream of seed 0), both under
``REPRO_BWD_PLAN=scatter``.  Compared each round: the loss, the dense
leaves, and how many score coordinates differ (a mask bit drawn within
Box-Muller's rounding of its uniform flips on one side only and moves
that coordinate's client mean by 1/K; from then on the two runs part).

Run as a script, it does the same with ``launch/train.py``'s other
defaults (K=4, E=2, batch 4, sequence 128, compression 8, d=8, lr
0.05, the inputs of ``chip_smoke.py`` phases 14 and 15) at scale 0.1
(qwen2-0.5b at 7 layers, d_model 256, 4 heads with 2 KV heads, d_ff
1536, vocab 8192, f32: 13.8M weights) for 3 rounds, and prints both
trajectories as one JSON line (~3 minutes on a CPU; the entry point's
default scale 0.25 took more than 25 GB here).  Other flags of the
entry point may follow, e.g. ``--scale 0.25 --rounds 1``:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_reference.py
"""

import json
import os
import resource
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import federated as jfed, zampling as jz
from repro.data import synthetic as jsyn
from repro.launch.train import scaled as jscaled
from repro.models.model import build_model as jbuild_model
from repro.models.model import loss_fn as jloss_fn
from repro_torch import convert
from repro_torch.core import federated as tfed
from repro_torch.launch import train as ttrain

# measured at the small size over 2 rounds: the losses equal in all
# printed digits, the dense leaves within 2.4e-7, no score differing
LOSS_RTOL = 1e-5
DENSE_ATOL = 1e-6
MAX_FLIP_SHARE = 1e-3


def trajectories(argv):
    """Per-round (port loss, JAX loss, largest dense difference, score
    coordinates that differ) of the run ``argv`` names, and n_total."""
    args = ttrain.parser().parse_args(argv + ["--device", "cpu"])
    run = ttrain.build(args)
    jcfg = jscaled(jget_arch(args.arch), args.scale)
    model = jbuild_model(jcfg)
    jzs = jz.build_specs(
        jax.eval_shape(model.init_params, jax.random.PRNGKey(0)),
        jz.ZamplingConfig(compression=args.compression, d=args.d,
                          min_size=4096))
    assert convert.zspecs_from_jax(jzs).specs == run.zspecs.specs
    jstate = {"scores": {p: jnp.asarray(v.numpy())
                         for p, v in run.state["scores"].items()},
              "dense": {p: jnp.asarray(v.float().numpy()).astype(jcfg.dtype)
                        for p, v in run.state["dense"].items()}}
    jfc = jfed.FederatedConfig(num_clients=args.clients,
                               local_steps=args.local_steps,
                               local_lr=args.lr)
    round_fn = jax.jit(lambda s, b, key: jfed.federated_round(
        jzs, s, lambda prm, bb: jloss_fn(model, prm, bb), b, key, jfc))
    jstream = jsyn.lm_token_batches(
        jcfg.vocab, args.clients * args.local_steps * args.batch,
        args.seq + 1, seed=0)
    rows = []
    for r in range(args.rounds):
        batch = run.batch()
        toks = next(jstream).reshape(args.clients, args.local_steps,
                                     args.batch, args.seq + 1)
        np.testing.assert_array_equal(toks[..., :-1], batch["tokens"])
        run.state, met = tfed.federated_round(
            run.zspecs, run.state, run.loss, batch, run.words[r], run.fcfg,
            device="cpu")
        jstate, jmet = round_fn(
            jstate, {"tokens": jnp.asarray(toks[..., :-1]),
                     "labels": jnp.asarray(toks[..., :-1])},
            np.uint32(run.words[r]))
        dense = max((float(np.abs(run.state["dense"][p].float().numpy()
                                  - np.asarray(jstate["dense"][p],
                                               np.float32)).max())
                     for p in run.zspecs.dense_paths), default=0.0)
        differ = sum(int((run.state["scores"][p].numpy()
                          != np.asarray(jstate["scores"][p])).sum())
                     for p in run.zspecs.specs)
        rows.append((float(met["loss"]), float(jmet["loss"]), dense, differ))
    return rows, run.zspecs.n_total


def test_lm_trajectory_against_jax(monkeypatch):
    monkeypatch.setenv("REPRO_BWD_PLAN", "scatter")
    rows, n_total = trajectories(
        ["--scale", "0.01", "--rounds", "2", "--clients", "2",
         "--local-steps", "2", "--batch", "2", "--seq", "16"])
    for loss, jloss, dense, differ in rows:
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        assert dense <= DENSE_ATOL
        assert differ <= MAX_FLIP_SHARE * 2 * n_total


if __name__ == "__main__":
    os.environ["REPRO_BWD_PLAN"] = "scatter"
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    argv = ["--scale", "0.1", "--rounds", "3"] + sys.argv[1:]
    t0 = time.perf_counter()
    rows, n_total = trajectories(argv)
    print(json.dumps({
        "argv": argv, "n_total": n_total,
        "port_loss": [r[0] for r in rows], "jax_loss": [r[1] for r in rows],
        "dense_max_abs_diff": [r[2] for r in rows],
        "scores_differing": [r[3] for r in rows],
        "seconds": time.perf_counter() - t0,
        "max_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        / 2**20}))
