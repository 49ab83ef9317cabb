"""FEDERATED ZAMPLING end-to-end on the PyTorch port (paper §3.2 setup).

The port (``src/repro_torch``) of ``examples/federated_mnistfc.py``'s
path where every client takes part in every round: 10 clients, an
MNIST-shaped network, m/n = 8.  Each round the clients upload n BITS
(the sampled masks) instead of 32m float bits, and the server averages
the masks into the new probability vector.  ``--aggregate`` picks the
wire transport (mean_f32, psum_u32, allgather_packed: the same bits,
other bytes); ``--downlink`` the server broadcast codec (f32; u16/u8
words; packed4/packed2, sub-byte words in uint32 lanes).  The carried
state between rounds IS the encoded wire representation, and the
evaluation samples networks straight from it, in the kernel.

The rounds run through ``federated_fit``, ``--block`` rounds at a time,
each block followed by an evaluation of 10 sampled networks.  Scores
start uniform from a numpy seed (the JAX example draws them with
``jax.random``, which has no torch twin); the round words come from the
same numpy seed.  The kernels run on the card (``--device cuda``, the
default); ``--device cpu`` runs their plain torch versions.

  PYTHONPATH=src python examples/federated_mnistfc_torch.py [--rounds 25]
  PYTHONPATH=src python examples/federated_mnistfc_torch.py \\
      --aggregate allgather_packed --downlink packed4
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.comm.metering import (downlink_table, round_wire_report,
                                       wire_table)
from repro_torch.core.federated import FederatedConfig, encode_state
from repro_torch.core.zampling import ZamplingConfig, build_specs, init_state
from repro_torch.data import (client_batch_stream, iid_client_split,
                              make_teacher_dataset)
from repro_torch.models.mlp import (SMALL_DIMS, mlp_accuracy, mlp_loss,
                                    mlp_template)
from repro_torch.train import evaluate, federated_fit

EVAL_NETS = 10

# flags of the JAX example whose paths the port does not run yet, and the
# ROADMAP item (queue 1) that brings each
_LATER = {
    "population": "item 6 (partial participation and streaming)",
    "cohort": "item 6 (partial participation and streaming)",
    "dropout_rate": "item 6 (partial participation and streaming)",
    "stream_chunk": "item 6 (partial participation and streaming)",
    "downlink_schedule": "item 7 (downlink schedules)",
    "het_table": "item 10 (model zoo and tooling: experiments/paper.py)",
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=30)
    ap.add_argument("--compression", type=float, default=8.0)
    ap.add_argument("--aggregate", default="psum_u32",
                    help="wire transport: mean_f32 | psum_u32 | "
                         "allgather_packed")
    ap.add_argument("--downlink", default="u8",
                    help="server broadcast codec: f32 | u16 | u8 | packed4 "
                         "| packed2 (sub-byte words in uint32 lanes)")
    ap.add_argument("--downlink-schedule", default="constant",
                    help="downlink rate schedule; only constant is ported")
    ap.add_argument("--schedule-b-min", type=int, default=2)
    ap.add_argument("--block", type=int, default=5,
                    help="rounds per fit call (and evaluation period)")
    ap.add_argument("--population", type=int, default=0,
                    help="virtual clients N (0: every client, every round)")
    ap.add_argument("--cohort", type=int, default=0)
    ap.add_argument("--dropout-rate", type=float, default=0.0)
    ap.add_argument("--beta", type=float, default=0.5)
    ap.add_argument("--min-clients", type=int, default=1)
    ap.add_argument("--stream-chunk", type=int, default=0)
    ap.add_argument("--het-table", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="numpy seed of the scores and the round words")
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    return ap


def refuse_unported(args) -> None:
    """Exit non-zero on a flag whose path the port does not run yet."""
    default = {"population": 0, "cohort": 0, "dropout_rate": 0.0,
               "stream_chunk": 0, "downlink_schedule": "constant",
               "het_table": False}
    for name, item in _LATER.items():
        if getattr(args, name) != default[name]:
            flag = "--" + name.replace("_", "-")
            sys.exit(f"{flag} is not ported to repro_torch yet; it comes "
                     f"with ROADMAP {item}")


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    refuse_unported(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    rng = np.random.RandomState(args.seed)

    ds = make_teacher_dataset(n_train=8000, n_test=1500, seed=0)
    zspecs = build_specs(mlp_template(SMALL_DIMS), ZamplingConfig(
        compression=args.compression, d=10, window=128, min_size=128))
    scores = {p: rng.rand(s.n).astype(np.float32)
              for p, s in zspecs.specs.items()}
    state = init_state(zspecs, scores, device=dev)

    rep = round_wire_report(zspecs, args.aggregate, args.clients,
                            downlink=args.downlink)
    print(f"m={zspecs.m_total} n={zspecs.n_total}; transport="
          f"{rep['transport']}: client upload "
          f"{rep['uplink_bytes_per_client'] / 1024:.1f} KiB/round vs naive "
          f"f32 {rep['naive_uplink_bytes_per_client'] / 1024:.1f} KiB "
          f"({rep['naive_uplink_bytes_per_client'] / rep['uplink_bytes_per_client']:.0f}x less)")
    for row in wire_table(zspecs, args.clients, downlink=args.downlink):
        print(f"  {row['strategy']:>17}: "
              f"{row['uplink_bytes_per_client'] / 1024:8.1f} "
              f"KiB/client/round ({row['uplink_vs_f32']:.4f}x of f32)")
    print(f"downlink codec={rep['downlink']}: server broadcast "
          f"{rep['downlink_bytes_per_client'] / 1024:.1f} KiB/client/round "
          f"({rep['downlink_vs_f32']:.4f}x of f32)")
    for row in downlink_table(zspecs, args.clients, aggregate=args.aggregate):
        print(f"  {row['codec']:>17}: "
              f"{row['downlink_bytes_per_client'] / 1024:8.1f} "
              f"KiB/client/round ({row['downlink_vs_f32']:.4f}x of f32)")

    clients = iid_client_split(ds, args.clients)
    stream = client_batch_stream(clients, 64, args.local_steps, seed=0)
    cfg = FederatedConfig(num_clients=args.clients,
                          local_steps=args.local_steps, local_lr=0.5,
                          aggregate=args.aggregate, downlink=args.downlink,
                          min_clients=args.min_clients)
    # the round carry is the ENCODED broadcast: u8/u16 words or uint32
    # lanes between rounds, never an f32 score slab
    state = encode_state(zspecs, cfg, state, device=dev)
    test = {"x": torch.from_numpy(ds.x_test).to(dev),
            "y": torch.from_numpy(ds.y_test).to(dev)}
    eval_words = [int(w) for w in rng.randint(0, 2**32, EVAL_NETS,
                                              dtype=np.uint64)]

    done, total_down = 0, 0.0
    while done < args.rounds:
        r = min(args.block, args.rounds - done)
        words = [int(w) for w in rng.randint(0, 2**32, r, dtype=np.uint64)]
        xs, ys = zip(*(next(stream) for _ in range(r)))
        state, mets = federated_fit(
            zspecs, state, mlp_loss,
            {"x": torch.from_numpy(np.stack(xs)).to(dev),
             "y": torch.from_numpy(np.stack(ys)).to(dev)}, words, cfg,
            device=dev)
        done += r
        ms, std = evaluate(zspecs, state,
                           lambda prm: mlp_accuracy(prm, test), eval_words,
                           carried=args.downlink, device=dev)
        losses = mets["loss"].cpu().numpy()
        down = np.asarray(mets["downlink_bytes_per_client"], np.float64)
        total_down += float(down.sum())
        down_col = " ".join(f"{b / 1024:.1f}" for b in down)
        print(f"round {done:3d}: loss={losses[-1]:.3f} "
              f"(block mean {losses.mean():.3f}) "
              f"sampled-acc={ms:.3f}+-{std:.3f} down/client KiB: {down_col}",
              flush=True)
    print(f"cumulative downlink: {total_down / 1024:.1f} KiB/client over "
          f"{args.rounds} rounds ({args.downlink}, "
          f"schedule={args.downlink_schedule})")
    print("done — every upload was a binary mask and every broadcast was "
          f"{args.downlink} wire words, never a naive float tensor.")


if __name__ == "__main__":
    main()
