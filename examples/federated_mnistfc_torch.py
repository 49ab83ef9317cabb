"""FEDERATED ZAMPLING end-to-end on the PyTorch port (paper §3.2 setup).

The port (``src/repro_torch``) of ``examples/federated_mnistfc.py``: 10
clients, an MNIST-shaped network, m/n = 8.  Each round the clients
upload n BITS (the sampled masks) instead of 32m float bits, and the
server averages the masks into the new probability vector.
``--aggregate`` picks the wire transport (mean_f32, psum_u32,
allgather_packed: the same bits, other bytes); ``--downlink`` the server
broadcast codec (f32; u16/u8 words; packed4/packed2, sub-byte words in
uint32 lanes); ``--downlink-schedule`` a width schedule for it (cosine
over ``--rounds``, or frontier, per tensor from the measured flip
fraction), whose realized bytes a round are printed.  The carried state
between rounds IS the encoded wire representation, and the evaluation
samples networks straight from it, in the kernel.

Partial participation: ``--population N`` splits the data over N
clients of unequal size (Dirichlet, ``--beta``), of which ``--cohort K``
are drawn each round by the counter-hash cohort draw; ``--dropout-rate
p`` drops each drawn client with probability p.  The server takes the
sample-count-weighted mean over the survivors, skips a round with fewer
than ``--min-clients``, and the run prints a participation table with
the realized wire bytes.  ``--stream-chunk C`` folds the uploads C
clients at a time (the same scores, no (K, lanes) slab).

The rounds run through ``federated_fit``, ``--block`` rounds at a time,
each block followed by an evaluation of 10 sampled networks.  Scores
start uniform from a numpy seed (the JAX example draws them with
``jax.random``, which has no torch twin); the round words come from the
same numpy seed.  The kernels run on the card (``--device cuda``, the
default); ``--device cpu`` runs their plain torch versions.
``--het-table`` prints the heterogeneity table instead (accuracy against
Dirichlet beta per downlink codec, ``experiments.run_heterogeneity`` at
its quick grid) and exits.

  PYTHONPATH=src python examples/federated_mnistfc_torch.py [--rounds 25]
  PYTHONPATH=src python examples/federated_mnistfc_torch.py \\
      --aggregate allgather_packed --downlink packed4
  PYTHONPATH=src python examples/federated_mnistfc_torch.py \\
      --population 100 --cohort 10 --dropout-rate 0.2
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.comm.metering import (downlink_table, round_wire_report,
                                       wire_table)
from repro_torch.core.federated import FederatedConfig, encode_state
from repro_torch.core.zampling import ZamplingConfig, build_specs, init_state
from repro_torch.data import (client_batch_stream, cohort_batch_stream,
                              dirichlet_client_split, iid_client_split,
                              make_teacher_dataset)
from repro_torch.experiments import run_heterogeneity
from repro_torch.fault import ClientPopulation, FaultPlan
from repro_torch.models.mlp import (SMALL_DIMS, mlp_accuracy, mlp_loss,
                                    mlp_template)
from repro_torch.train import evaluate, federated_fit

EVAL_NETS = 10
FAULT_COLS = ("num_participating", "num_dropped", "num_stragglers",
              "num_corrupt", "num_duplicates", "round_skipped")


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
                    help="downlink rate schedule: constant | cosine (width "
                         "annealed up over --rounds) | frontier (per-tensor "
                         "width from the measured flip fraction)")
    ap.add_argument("--schedule-b-min", type=int, default=2,
                    help="the schedules' floor width in bits")
    ap.add_argument("--block", type=int, default=5,
                    help="rounds per fit call (and evaluation period)")
    ap.add_argument("--population", type=int, default=0,
                    help="virtual clients N (0: every client, every round)")
    ap.add_argument("--cohort", type=int, default=0,
                    help="clients drawn a round (default: --clients)")
    ap.add_argument("--dropout-rate", type=float, default=0.0,
                    help="chance a drawn client drops the round")
    ap.add_argument("--beta", type=float, default=0.5,
                    help="Dirichlet concentration of the non-IID split")
    ap.add_argument("--min-clients", type=int, default=1,
                    help="skip rounds with fewer survivors than this")
    ap.add_argument("--stream-chunk", type=int, default=0,
                    help="fold the uploads this many clients at a time "
                         "(0: one slab)")
    ap.add_argument("--het-table", action="store_true",
                    help="print the heterogeneity table (accuracy against "
                         "Dirichlet beta per downlink codec) and exit")
    ap.add_argument("--seed", type=int, default=0,
                    help="numpy seed of the scores and the round words")
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    return ap


def het_table(device) -> None:
    """The JAX example's heterogeneity table, a row per (beta, codec)."""
    print("accuracy vs Dirichlet beta x downlink codec (quick grid)")
    print(f"{'beta':>6} {'codec':>6} {'acc':>7} {'std':>6} "
          f"{'down KiB':>9} {'vs f32':>7}")
    for row in run_heterogeneity(quick=True, device=device):
        print(f"{row['beta']:>6.2f} {row['codec']:>6} "
              f"{row['final_sampled_acc']:>7.3f} {row['sampled_std']:>6.3f} "
              f"{row['downlink_bytes_per_client'] / 1024:>9.1f} "
              f"{row['downlink_vs_f32']:>7.4f}", flush=True)


def main(argv=None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    if args.het_table:
        torch.backends.cuda.matmul.allow_tf32 = False
        het_table(torch.device(args.device))
        return
    use_cohort = args.population > 0
    cohort = args.cohort or args.clients
    if use_cohort and cohort > args.population:
        ap.error(f"--cohort {cohort} exceeds --population {args.population}")
    k = cohort if use_cohort else args.clients
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    rng = np.random.RandomState(args.seed)

    ds = make_teacher_dataset(n_train=8000, n_test=1500, seed=0)
    zspecs = build_specs(mlp_template(SMALL_DIMS), ZamplingConfig(
        compression=args.compression, d=10, window=128, min_size=128))
    scores = {p: rng.rand(s.n).astype(np.float32)
              for p, s in zspecs.specs.items()}
    state = init_state(zspecs, scores, device=dev)

    rep = round_wire_report(zspecs, args.aggregate, k,
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

    plan = None
    if use_cohort:
        clients, hist = dirichlet_client_split(ds, args.population,
                                               beta=args.beta, seed=0)
        sizes = hist.sum(axis=1)
        pop = ClientPopulation(args.population,
                               sample_counts=tuple(int(s) for s in sizes),
                               seed=0)
        plan = FaultPlan(dropout=args.dropout_rate)
        stream = cohort_batch_stream(clients, pop, cohort, 64,
                                     args.local_steps, seed=0)
        print(f"population N={args.population} (Dirichlet beta={args.beta}, "
              f"client sizes {sizes.min()}..{sizes.max()}), cohort "
              f"K={cohort}, dropout p={args.dropout_rate}")
    else:
        clients = iid_client_split(ds, args.clients)
        stream = client_batch_stream(clients, 64, args.local_steps, seed=0)
    sched = {}
    if args.downlink_schedule != "constant":
        sched = {"downlink_schedule": args.downlink_schedule,
                 "schedule_b_min": args.schedule_b_min}
        if args.downlink_schedule == "cosine":
            sched["schedule_rounds"] = args.rounds
    cfg = FederatedConfig(num_clients=k, local_steps=args.local_steps,
                          local_lr=0.5, aggregate=args.aggregate,
                          downlink=args.downlink,
                          min_clients=args.min_clients,
                          stream_chunk=args.stream_chunk, **sched)
    # the round carry is the ENCODED broadcast: u8/u16 words or uint32
    # lanes between rounds, never an f32 score slab
    state = encode_state(zspecs, cfg, state, device=dev)
    test = {"x": torch.from_numpy(ds.x_test).to(dev),
            "y": torch.from_numpy(ds.y_test).to(dev)}
    eval_words = [int(w) for w in rng.randint(0, 2**32, EVAL_NETS,
                                              dtype=np.uint64)]

    if use_cohort:
        print(f"{'round':>5} {'part':>4} {'drop':>4} {'strag':>5} "
              f"{'corr':>4} {'dup':>3} {'skip':>4} {'w_sum':>7} "
              f"{'uplink KiB':>10} {'down KiB':>8}")
    done, total_down = 0, 0.0
    while done < args.rounds:
        r = min(args.block, args.rounds - done)
        words = [int(w) for w in rng.randint(0, 2**32, r, dtype=np.uint64)]
        items = [next(stream) for _ in range(r)]
        part = {}
        if use_cohort:
            ids, ws, xs, ys = zip(*items)
            part = {"client_ids": np.stack(ids), "weights": np.stack(ws),
                    "faults": plan}
        else:
            xs, ys = zip(*items)
        # each block counts its rounds from 0, as the JAX example's
        # federated_fit calls do
        state, mets = federated_fit(
            zspecs, state, mlp_loss,
            {"x": torch.from_numpy(np.stack(xs)).to(dev),
             "y": torch.from_numpy(np.stack(ys)).to(dev)}, words, cfg,
            device=dev, **part)
        down = np.asarray(_host(mets["downlink_bytes_per_client"]),
                          np.float64)
        if use_cohort:
            cols = {c: _host(mets[c]) for c in FAULT_COLS}
            up = _host(mets["uplink_bytes_round"])
            wsum = _host(mets["weight_sum"])
            for j in range(r):
                print(f"{done + j:>5} {cols['num_participating'][j]:>4.0f} "
                      f"{cols['num_dropped'][j]:>4.0f} "
                      f"{cols['num_stragglers'][j]:>5.0f} "
                      f"{cols['num_corrupt'][j]:>4.0f} "
                      f"{cols['num_duplicates'][j]:>3.0f} "
                      f"{cols['round_skipped'][j]:>4.0f} "
                      f"{wsum[j]:>7.0f} {up[j] / 1024:>10.1f} "
                      f"{down[j] / 1024:>8.1f}", flush=True)
        done += r
        ms, std = evaluate(zspecs, state,
                           lambda prm: mlp_accuracy(prm, test), eval_words,
                           carried=args.downlink, device=dev)
        losses = _host(mets["loss"])
        # realized downlink a client, a round: a scheduled round meters
        # its width's bits and the lanes' padding
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


def _host(v) -> np.ndarray:
    """A stacked metric (a tensor or a numpy array) on the host."""
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


if __name__ == "__main__":
    main()
