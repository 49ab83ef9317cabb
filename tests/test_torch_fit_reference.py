"""Several federated rounds of the port against the JAX package's, each
side carrying its own state, on the same inputs.

A round's test (``test_torch_federated.py``) starts both sides from one
state.  Here each side runs its own trajectory: the same numpy scores
and data stream, the same uint32 round words, the same evaluation
words, and the loss of every round and the sampled accuracy before and
after compared.  A fault that only shows over several rounds (a wrong
carry, a draw word reused across rounds, a mis-scaled step) makes the
trajectories part.  JAX runs on the CPU through its plain reference
(``impl="ref"``), under ``jax.jit`` as its fit loops run it; the port
runs its plain torch path on the CPU.

Run as a script, it does the same at the size of the paper's Fig. 4
(``experiments/paper.py`` at ``quick=False``): MNISTFC 784-300-100-10,
K=10 clients, E=100 local steps, batch 64, 5 rounds, the teacher
dataset of 8000/1500 examples, 10 sampled networks, on the inputs that
``chip_smoke.py`` draws (scores, round words and evaluation words from
``numpy.random.RandomState(0)``, zero biases, data stream seed 0), and
prints both sides' per-round losses and accuracies, and the u8 words
on which they differ after each round, as one JSON line (about 2.5
minutes on a CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fit_reference.py
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import federated as jfed, zampling as jz
from repro.models import mlp as jmlp
from repro_torch.core import federated as tfed
from repro_torch.core.zampling import ZamplingConfig, build_specs
from repro_torch.data import federated_split as tsplit, synthetic as tsyn
from repro_torch.models import mlp as tmlp
from repro_torch.train import evaluate

ZC = dict(compression=8, d=10, window=128, min_size=128, seed=1)
LOSS_RTOL = 1e-4  # a loss sums many products of Box-Muller-rounded weights
MAX_FLIP_SHARE = 1e-3  # u8 words off upload bits flipped by that rounding


def _jtemplate(dims):
    return {f"layer{i}": {"kernel": jax.ShapeDtypeStruct((a, b), jnp.float32),
                          "bias": jax.ShapeDtypeStruct((b,), jnp.float32)}
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}


def inputs(dims, K, E, batch, rounds, n_train, n_test, eval_nets, seed=0):
    """The run's inputs, drawn as ``chip_smoke.py`` draws them."""
    zs = build_specs(tmlp.mlp_template(dims), ZamplingConfig(**ZC))
    rng = np.random.RandomState(seed)
    scores = {p: rng.rand(s.n).astype(np.float32) for p, s in zs.specs.items()}
    dense = {p: np.zeros(zs.template[p].shape, np.float32)
             for p in zs.dense_paths}
    round_words = [int(w) for w in rng.randint(0, 2**32, rounds,
                                                dtype=np.uint64)]
    eval_words = [int(w) for w in rng.randint(0, 2**32, eval_nets,
                                              dtype=np.uint64)]
    ds = tsyn.make_teacher_dataset(n_train=n_train, n_test=n_test, seed=0)
    stream = tsplit.client_batch_stream(tsplit.iid_client_split(ds, K, seed=0),
                                        batch, E, seed=0)
    batches = [dict(zip(("x", "y"), next(stream))) for _ in range(rounds)]
    fc = dict(num_clients=K, local_steps=E, local_lr=0.5,
              aggregate="psum_u32", downlink="u8")
    return dict(dims=dims, zs=zs, fc=fc, init={"scores": scores,
                                                "dense": dense},
                round_words=round_words, eval_words=eval_words,
                batches=batches, test={"x": ds.x_test, "y": ds.y_test})


def run_jax(inp):
    """JAX's trajectory: (per-round losses, sampled accuracy before and
    after as (mean, std), the u8 words after each round)."""
    jzs = jz.build_specs(_jtemplate(inp["dims"]), jz.ZamplingConfig(**ZC))
    jcfg = jfed.FederatedConfig(**inp["fc"])
    state = jfed.encode_state(jzs, jcfg, jax.tree_util.tree_map(
        jnp.asarray, inp["init"]), 0)
    test = {n: jnp.asarray(v) for n, v in inp["test"].items()}
    accuracy = jax.jit(jmlp.mlp_accuracy)

    def sampled_accuracy(st):
        accs = [float(accuracy(jz.sample_weights(jzs, st, np.uint32(w),
                                                 carried="u8"), test))
                for w in inp["eval_words"]]
        return float(np.mean(accs)), float(np.std(accs))

    step = jax.jit(lambda s, b, w, r: jfed.federated_round(
        jzs, s, jmlp.mlp_loss, b, w, jcfg, round_index=r))
    before = sampled_accuracy(state)
    losses, words = [], []
    for r, b in enumerate(inp["batches"]):
        state, met = step(state, {n: jnp.asarray(v) for n, v in b.items()},
                          np.uint32(inp["round_words"][r]), np.uint32(r))
        losses.append(float(met["loss"]))
        words.append({p: np.asarray(state["scores"][p])
                      for p in inp["zs"].specs})
    return losses, before, sampled_accuracy(state), words


def run_port(inp):
    """The port's trajectory on the CPU, as ``run_jax`` returns it."""
    zs = inp["zs"]
    cfg = tfed.FederatedConfig(**inp["fc"])
    state = tfed.encode_state(zs, cfg, inp["init"], device="cpu")
    test = {n: torch.from_numpy(v) for n, v in inp["test"].items()}

    def sampled_accuracy(st):
        return evaluate(zs, st, lambda prm: tmlp.mlp_accuracy(prm, test),
                        inp["eval_words"], carried="u8", device="cpu")

    before = sampled_accuracy(state)
    losses, words = [], []
    for r, b in enumerate(inp["batches"]):
        state, met = tfed.federated_round(zs, state, tmlp.mlp_loss, b,
                                          inp["round_words"][r], cfg,
                                          round_index=r, device="cpu")
        losses.append(float(met["loss"]))
        words.append({p: state["scores"][p].numpy() for p in zs.specs})
    return losses, before, sampled_accuracy(state), words


def test_three_rounds_follow_the_jax_trajectory():
    inp = inputs(jmlp.SMALL_DIMS, K=3, E=2, batch=8, rounds=3, n_train=240,
                 n_test=60, eval_nets=2)
    j_loss, j_before, j_after, j_words = run_jax(inp)
    t_loss, t_before, t_after, t_words = run_port(inp)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    for t, j in zip(t_words, j_words):
        differ = sum(int((t[p] != j[p]).sum()) for p in t)
        assert differ <= MAX_FLIP_SHARE * inp["zs"].n_total
    # a prediction may flip where two logits tie within the rounding
    for t, j in ((t_before, j_before), (t_after, j_after)):
        assert abs(t[0] - j[0]) <= 1.0 / len(inp["test"]["y"])


def main():
    inp = inputs(jmlp.MNISTFC_DIMS, K=10, E=100, batch=64, rounds=5,
                 n_train=8000, n_test=1500, eval_nets=10)
    out = {"config": "MNISTFC 784-300-100-10, compression 8, d=10, window "
           "128, K=10, E=100, batch 64, lr 0.5, psum_u32/u8",
           "round_words": inp["round_words"]}
    words = {}
    for name, fn in (("jax", run_jax), ("port_cpu", run_port)):
        t0 = time.perf_counter()
        loss, before, after, words[name] = fn(inp)
        out[name] = {"losses": loss, "accuracy_before": before,
                     "accuracy_after": after,
                     "seconds": time.perf_counter() - t0}
        print(f"{name}: losses {loss}; sampled accuracy {before[0]:.4f} -> "
              f"{after[0]:.4f}", flush=True)
    out["u8_words_differing_by_round"] = [
        sum(int((j[p] != t[p]).sum()) for p in inp["zs"].specs)
        for j, t in zip(words["jax"], words["port_cpu"])]
    out["u8_words"] = inp["zs"].n_total
    print(json.dumps(out))


if __name__ == "__main__":
    main()
