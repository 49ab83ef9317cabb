"""Quickstart on the PyTorch port: Zampling in 60 lines.

The port (``src/repro_torch``) of ``examples/quickstart.py``:
reparametrize a small MLP with w = Q z (m/n = 4, d = 5), train the
probability vector by sampling (LOCAL ZAMPLING, paper §1.3), and show
that sampled networks match the expected network's accuracy.  The
template, scores and draw words come from numpy seeds where the JAX
example takes PRNG keys (0, 1 and 2).  The kernels run on the card
(``--device cuda``, the default); ``--device cpu`` runs their plain
torch versions.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core.sampling import init_scores
from repro_torch.core.zampling import ZamplingConfig, build_specs, init_state
from repro_torch.data import make_teacher_dataset
from repro_torch.device import resolve_device
from repro_torch.models.mlp import (SMALL_DIMS, init_mlp_params,
                                    mlp_accuracy, mlp_loss)
from repro_torch.train import LocalTrainConfig, evaluate, train_local_zampling


def words(seed, count):
    return [int(w) for w in np.random.RandomState(seed).randint(
        0, 2**32, count, dtype=np.uint64)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(args.device)

    ds = make_teacher_dataset(n_train=6000, n_test=1200, seed=0)
    test_batch = {"x": torch.from_numpy(ds.x_test).to(dev),
                  "y": torch.from_numpy(ds.y_test).to(dev)}

    # 1. template network -> QSpecs (the influence matrix, never built)
    template = init_mlp_params(np.random.RandomState(0), SMALL_DIMS)
    zspecs = build_specs(template, ZamplingConfig(compression=4.0, d=5,
                                                  window=128, min_size=128))
    print(f"weights m={zspecs.m_total}, trainable n={zspecs.n_total} "
          f"({zspecs.compression:.1f}x compression)")
    bits = zspecs.comm_bits_per_round()
    print(f"federated client upload: {bits['client_up']} bits vs naive "
          f"{bits['naive_client_up']} "
          f"({bits['naive_client_up'] / bits['client_up']:.0f}x)")

    # 2. train-by-sampling: a fresh Bernoulli mask every forward pass
    rng = np.random.RandomState(1)
    scores = {p: init_scores(rng, s.n) for p, s in zspecs.specs.items()}
    state = init_state(zspecs, scores, dense_init=template, device=dev)
    batches = ({"x": x, "y": y} for x, y in ds.batches(128, seed=0))
    state, hist = train_local_zampling(
        zspecs, state, mlp_loss, batches,
        LocalTrainConfig(steps=args.steps, lr=1e-2), words(0, args.steps),
        device=dev)
    print(f"loss: {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}")

    # 3. evaluate sampled against expected networks
    def acc(params):
        return mlp_accuracy(params, test_batch)

    mean_s, std_s = evaluate(zspecs, state, acc, words(2, 20), device=dev)
    mean_e, _ = evaluate(zspecs, state, acc, mode="continuous", device=dev)
    print(f"sampled accuracy  {mean_s:.3f} +- {std_s:.3f}")
    print(f"expected accuracy {mean_e:.3f}  (paper: the two should be close "
          f"after training-by-sampling)")


if __name__ == "__main__":
    main()
