"""Local zampling in the port against the JAX package's, each side
carrying its own state, on the same inputs.

JAX runs the body of its trainer's ``train_step``
(``repro/train/local.py:48-57``: ``sample_weights`` at the step's
uint32 draw word, ``adam``, ``apply_updates``) under ``jax.jit``, on
the CPU through its plain reference (``impl="ref"``); the port runs
``train_local_zampling`` on its plain torch path on the CPU.  Both
start from the same numpy scores and zero biases, take the same batches
and draw at the same words.  Compared: the first step's score
gradients and Adam-updated scores, the loss at every step, and at the
end the expected (continuous) network's accuracy.

Box-Muller's log/cos round differently in XLA and torch, so Q, the
weights and the gradients are allclose, not bitwise.  Adam's first
step moves a score by about lr in the direction of its gradient's sign,
so the updated scores agree to an ulp or two wherever the gradients'
signs do.  A mask bit drawn where a probability lies within that
rounding of its uniform would flip on one side only and part the
trajectories; at the small size none flips in 30 steps.  The
tolerances below were set from the measurement at the small size.

Run as a script, it does the same at the size of the paper's Fig. 6
``zampling_d16`` (``experiments/paper.py:466-492`` at ``quick=False``):
MNISTFC 784-300-100-10 at compression 1, d=16, window 128, the teacher
dataset of 8000/1500 examples, batch 128, Adam at lr 1e-2, 500 steps
(the paper runs 4000), on the inputs that ``chip_smoke.py`` draws
(scores and step words from ``numpy.random.RandomState(0)``, zero
biases, batches from seed 0), and prints both sides' per-step losses
and their sampled (10 networks), best-mask, expected and discretized
accuracies as one JSON line (several minutes on a CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_local_reference.py
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import zampling as jz
from repro.models import mlp as jmlp
from repro.optim import optimizers as jopt
from repro.train import local as jlocal
from repro_torch.core.zampling import (ZamplingConfig, build_specs,
                                       init_state, sample_weights)
from repro_torch.data import synthetic as tsyn
from repro_torch.models import mlp as tmlp
from repro_torch.optim import adam
from repro_torch.train import (LocalTrainConfig, evaluate,
                               train_local_zampling, train_step)

LR = 1e-2
# measured at the small size: the first step's score gradients differ
# by at most 3.3e-7 of a leaf's largest gradient, the Adam-updated
# scores by at most 6e-8 (an ulp near 1), the losses of all 30 steps by
# at most 1.9e-7 relative (the bound leaves room for torch's CPU
# reductions, whose rounding varies with the thread count)
GRAD_RTOL_OF_MAX = 1e-5
SCORE_ATOL = 1e-6
LOSS_RTOL = 1e-5


def _jtemplate(dims):
    return {f"layer{i}": {"kernel": jax.ShapeDtypeStruct((a, b), jnp.float32),
                          "bias": jax.ShapeDtypeStruct((b,), jnp.float32)}
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}


def inputs(dims, compression, d, steps, n_train, n_test, eval_nets, seed=0):
    """The run's inputs, drawn as ``chip_smoke.py`` draws them."""
    zc = dict(compression=compression, d=d, window=128, min_size=128,
              seed=0)
    zs = build_specs(tmlp.mlp_template(dims), ZamplingConfig(**zc))
    rng = np.random.RandomState(seed)
    scores = {p: rng.rand(s.n).astype(np.float32) for p, s in zs.specs.items()}
    dense = {p: np.zeros(zs.template[p].shape, np.float32)
             for p in zs.dense_paths}
    step_words = [int(w) for w in rng.randint(0, 2**32, steps,
                                              dtype=np.uint64)]
    eval_words = [int(w) for w in rng.randint(0, 2**32, eval_nets,
                                              dtype=np.uint64)]
    ds = tsyn.make_teacher_dataset(n_train=n_train, n_test=n_test, seed=0)
    it = ds.batches(128, seed=0)
    batches = [dict(zip(("x", "y"), next(it))) for _ in range(steps)]
    return dict(dims=dims, zc=zc, zs=zs, scores=scores, dense=dense,
                step_words=step_words, eval_words=eval_words,
                batches=batches, test={"x": ds.x_test, "y": ds.y_test})


def run_jax(inp):
    """JAX's trajectory: {losses, grads0, scores1, accuracies}."""
    jzs = jz.build_specs(_jtemplate(inp["dims"]), jz.ZamplingConfig(
        **inp["zc"]))
    opt = jopt.adam(LR)

    @jax.jit
    def step(state, opt_state, batch, word):
        def loss(tr):
            return jmlp.mlp_loss(jz.sample_weights(jzs, tr, word), batch)

        l, grads = jax.value_and_grad(loss)(state)
        updates, opt_state = opt.update(grads, opt_state, state)
        return jopt.apply_updates(state, updates), opt_state, l, grads

    state = {"scores": {p: jnp.asarray(v) for p, v in inp["scores"].items()},
             "dense": {p: jnp.asarray(v) for p, v in inp["dense"].items()}}
    opt_state = opt.init(state)
    losses = []
    for t, b in enumerate(inp["batches"]):
        state, opt_state, l, grads = step(
            state, opt_state, {n: jnp.asarray(v) for n, v in b.items()},
            np.uint32(inp["step_words"][t]))
        losses.append(float(l))
        if t == 0:
            grads0 = {p: np.asarray(v) for p, v in grads["scores"].items()}
            scores1 = {p: np.asarray(v) for p, v in state["scores"].items()}
    test = {n: jnp.asarray(v) for n, v in inp["test"].items()}
    accuracy = jax.jit(jmlp.mlp_accuracy)
    sampled = [float(accuracy(jz.sample_weights(jzs, state, np.uint32(w)),
                              test)) for w in inp["eval_words"]]
    acc = {mode: jlocal.evaluate(jzs, state, lambda prm: accuracy(prm, test),
                                 np.uint32(0), mode=mode)[0]
           for mode in ("continuous", "discretize")}
    return dict(losses=losses, grads0=grads0, scores1=scores1,
                sampled=sampled, expected=acc["continuous"],
                discretized=acc["discretize"])


def run_port(inp):
    """The port's trajectory on the CPU, as ``run_jax`` returns it."""
    zs = inp["zs"]
    state0 = init_state(zs, inp["scores"], inp["dense"], device="cpu")
    opt = adam(LR)
    b0 = {n: torch.from_numpy(v) for n, v in inp["batches"][0].items()}
    state1, _, _, grads = train_step(zs, state0, opt.init(
        {**state0["scores"], **state0["dense"]}), b0, inp["step_words"][0],
        tmlp.mlp_loss, opt)
    cfg = LocalTrainConfig(steps=len(inp["batches"]), lr=LR,
                           eval_every=10**9)
    state, hist = train_local_zampling(zs, state0, tmlp.mlp_loss,
                                       iter(inp["batches"]), cfg,
                                       inp["step_words"], device="cpu")
    test = {n: torch.from_numpy(v) for n, v in inp["test"].items()}

    def accuracy(prm):
        return tmlp.mlp_accuracy(prm, test)

    with torch.no_grad():
        sampled = [float(accuracy(sample_weights(zs, state, w,
                                                 device="cpu")))
                   for w in inp["eval_words"]]
    acc = {mode: evaluate(zs, state, accuracy, mode=mode, device="cpu")[0]
           for mode in ("continuous", "discretize")}
    return dict(losses=hist["loss"],
                grads0={p: v.numpy() for p, v in grads["scores"].items()},
                scores1={p: v.numpy() for p, v in state1["scores"].items()},
                sampled=sampled, expected=acc["continuous"],
                discretized=acc["discretize"])


def test_thirty_steps_follow_the_jax_trajectory():
    inp = inputs(jmlp.SMALL_DIMS, compression=4, d=5, steps=30, n_train=2000,
                 n_test=500, eval_nets=2)
    j, t = run_jax(inp), run_port(inp)
    for p in inp["zs"].specs:
        g, jg = t["grads0"][p], j["grads0"][p]
        np.testing.assert_allclose(g, jg, rtol=0, atol=GRAD_RTOL_OF_MAX
                                   * np.abs(jg).max())
        np.testing.assert_allclose(t["scores1"][p], j["scores1"][p],
                                   rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=LOSS_RTOL)
    assert t["losses"][-1] < t["losses"][0]
    # a prediction may flip where two logits tie within the rounding
    assert abs(t["expected"] - j["expected"]) <= 1.0 / len(inp["test"]["y"])


def main():
    inp = inputs(jmlp.MNISTFC_DIMS, compression=1.0, d=16, steps=500,
                 n_train=8000, n_test=1500, eval_nets=10)
    out = {"config": "Fig. 6 zampling_d16: MNISTFC 784-300-100-10, "
           "compression 1, d=16, window 128, batch 128, Adam lr 1e-2, "
           "500 steps", "step_words_first": inp["step_words"][:3]}
    runs = {}
    for name, fn in (("jax", run_jax), ("port_cpu", run_port)):
        t0 = time.perf_counter()
        r = runs[name] = fn(inp)
        out[name] = {"losses": r["losses"],
                     "sampled_accuracy": [float(np.mean(r["sampled"])),
                                          float(np.std(r["sampled"]))],
                     "best_mask_accuracy": max(r["sampled"]),
                     "expected_accuracy": r["expected"],
                     "discretized_accuracy": r["discretized"],
                     "seconds": time.perf_counter() - t0}
        print(f"{name}: loss {r['losses'][0]:.6f} -> {r['losses'][-1]:.6f}; "
              f"expected {r['expected']:.4f}", flush=True)
    j, t = runs["jax"], runs["port_cpu"]
    out["grads0_max_abs_diff"] = {p: float(np.abs(t["grads0"][p]
                                                  - j["grads0"][p]).max())
                                  for p in inp["zs"].specs}
    out["scores1_max_abs_diff"] = {p: float(np.abs(t["scores1"][p]
                                                   - j["scores1"][p]).max())
                                   for p in inp["zs"].specs}
    out["loss_max_rel_diff"] = float(np.max(
        np.abs(np.array(t["losses"]) - j["losses"]) / np.abs(j["losses"])))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
