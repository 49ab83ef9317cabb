"""The paper's experiments (§3, App. A/B): the JAX package's
``experiments/paper.py`` on the port.

MNIST is unavailable offline; the synthetic teacher-student task
(784 -> 10, ``data.make_teacher_dataset``) stands in, so absolute
accuracies differ from the paper's and the claims held are its relative
statements.  Every ``run_*`` function returns a list of row dicts under
the JAX package's ``bench`` tags and keys; ``quick=True`` takes the JAX
package's small grids, ``quick=False`` the paper's (5 seeds, d in {1, 5,
10, 50, 100}, m/n = 2^i, Fig. 4 at MNISTFC width).  Each experiment is
one ``*_cell`` function a grid point, taking its sizes explicitly, so a
test or a smoke run can take one cell at a cut; ``experiment_cells``
lists a function's cells at its grid.

Randomness comes from numpy where the JAX package takes PRNG keys, at
the seeds of those keys: a network's template and dense leaves from
``RandomState(seed)``, its scores from ``RandomState(seed + 1)``, the
beta init from ``RandomState(seed + 2)`` (a leaf at a time, in
tensor-id order); the uint32 round, step and network words from
``RandomState(s)`` where the JAX package uses ``PRNGKey(s)``.  Table 4's
impulse on a leaf draws from ``RandomState([100 + i, tensor_id])``:
the JAX package folds ``hash(path)``, which Python salts per process.

Everything runs on the card unless ``device="cpu"``, which runs the
kernels' plain torch versions.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..comm.downlink import codec_names
from ..comm.metering import round_wire_report, wire_table
from ..core.federated import FederatedConfig, encode_state, federated_round
from ..core.sampling import init_scores
from ..core.zampling import (ZamplingConfig, build_specs, init_state,
                             sample_weights)
from ..core.zonotope import perturb_nontrivial
from ..data import (client_batch_stream, cohort_batch_stream,
                    dirichlet_client_split, iid_client_split,
                    make_teacher_dataset)
from ..device import resolve_device
from ..fault import ClientPopulation
from ..models.mlp import (MNISTFC_DIMS, SMALL_DIMS, init_mlp_params,
                          mlp_accuracy, mlp_loss, param_count)
from ..train import (LocalTrainConfig, evaluate, federated_fit,
                     train_local_zampling)

_DS = {}
Grid = List[Tuple[str, Callable[[], List[Dict]]]]


def _dataset(seed=0):
    if seed not in _DS:
        _DS[seed] = make_teacher_dataset(n_train=8000, n_test=1500, seed=seed)
    return _DS[seed]


def _words(seed: int, count: int) -> List[int]:
    """``count`` uint32 draw words from ``RandomState(seed)``."""
    return [int(w) for w in np.random.RandomState(seed).randint(
        0, 2**32, count, dtype=np.uint64)]


def _rows(grid: Grid) -> List[Dict]:
    return [row for _, cell in grid for row in cell()]


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def setup_arrays(dims, compression, d, seed, beta: Optional[tuple] = None):
    """(zspecs, {"scores", "dense"} as numpy) of one network: the JAX
    package's ``_setup`` (window 128, ``min_size`` 128, Q seeded by
    ``seed``), its draws from numpy."""
    template = init_mlp_params(np.random.RandomState(seed), dims)
    zspecs = build_specs(template, ZamplingConfig(
        compression=compression, d=d, window=128, seed=seed, min_size=128))
    if beta is None:
        rng, kw = np.random.RandomState(seed + 1), {}
    else:
        rng = np.random.RandomState(seed + 2)
        kw = dict(dist="beta", beta_a=beta[0], beta_b=beta[1])
    scores = {p: init_scores(rng, s.n, **kw) for p, s in zspecs.specs.items()}
    return zspecs, {"scores": scores,
                    "dense": {p: template[p] for p in zspecs.dense_paths}}


def _setup(dims, compression, d, seed, beta=None, *, device):
    zspecs, arrays = setup_arrays(dims, compression, d, seed, beta)
    return zspecs, init_state(zspecs, arrays["scores"], arrays["dense"],
                              device=device)


def _train(zspecs, state, ds, steps, lr, mode="sample", seed=0, *, device):
    """``steps`` local steps, batch 128 from ``ds.batches(128, seed)``;
    step t of sample mode draws at word t of ``RandomState(seed)``."""
    batches = ({"x": x, "y": y} for x, y in ds.batches(128, seed=seed))
    cfg = LocalTrainConfig(steps=steps, lr=lr, mode=mode, eval_every=10**9)
    words = _words(seed, steps) if mode == "sample" else None
    return train_local_zampling(zspecs, state, mlp_loss, batches, cfg, words,
                                device=device)


def _acc_fn(ds, dev):
    tb = {"x": torch.from_numpy(ds.x_test).to(dev),
          "y": torch.from_numpy(ds.y_test).to(dev)}
    return lambda params: mlp_accuracy(params, tb)


# ---------------------------------------------------------------------------
# §3.1 / Table 2 / Fig. 3: compression against accuracy across d
# ---------------------------------------------------------------------------

def local_compression_cell(d: int, compression: float, *,
                           seeds: Sequence[int] = (0,), steps: int = 800,
                           n_samples: int = 10, dims=SMALL_DIMS,
                           device="cuda") -> Dict:
    dev = resolve_device(device)
    ds = _dataset()
    acc = _acc_fn(ds, dev)
    sampled, expected = [], []
    for seed in seeds:
        zspecs, state = _setup(dims, compression, d, seed, device=dev)
        state, _ = _train(zspecs, state, ds, steps, 1e-2, seed=seed,
                          device=dev)
        ms, _ = evaluate(zspecs, state, acc, _words(9, n_samples),
                         device=dev)
        me, _ = evaluate(zspecs, state, acc, mode="continuous", device=dev)
        sampled.append(ms)
        expected.append(me)
    return {"bench": "table2_compression", "d": d, "compression": compression,
            "sampled_acc": float(np.mean(sampled)),
            "sampled_std": float(np.std(sampled)),
            "expected_acc": float(np.mean(expected))}


def _local_compression_grid(quick, device) -> Grid:
    seeds = [0] if quick else [0, 1, 2, 3, 4]
    return [(f"d={d} m/n={c}", lambda d=d, c=c: [local_compression_cell(
        d, c, seeds=seeds, steps=800 if quick else 4000,
        n_samples=10 if quick else 100, device=device)])
        for d in ([1, 5, 10] if quick else [1, 5, 10, 50, 100])
        for c in ([1, 4, 32] if quick else [2**i for i in range(11)])]


def run_local_compression(quick: bool = True, *, device="cuda") -> List[Dict]:
    return _rows(_local_compression_grid(quick, device))


# ---------------------------------------------------------------------------
# Table 1: communication savings (analytic, exact)
# ---------------------------------------------------------------------------

def comm_savings_table() -> List[Dict]:
    m = param_count(MNISTFC_DIMS)
    rows = [{
        "bench": "table1_comm", "method": "isik23_fedpm",
        "client_savings": 33.69, "server_savings": 1.05,
        "note": "paper-reported (*bit-rate 0.95 arithmetic coding)",
    }]
    for comp in (8, 32):
        n = int(np.ceil(m / comp))
        rows.append({
            "bench": "table1_comm", "method": f"zampling m/n={comp}",
            "client_savings": 32.0 * m / n,  # n bits against 32m bits
            "server_savings": float(m) / n,  # 32n against 32m
            "note": f"m={m}, n={n} (MNISTFC)",
        })
    return rows


# ---------------------------------------------------------------------------
# §3.2 / Fig. 4: federated zampling, m/n in {1, 8, 32}
# ---------------------------------------------------------------------------

def federated_cell(compression: float, *, dims=SMALL_DIMS, K: int = 10,
                   E: int = 40, rounds: int = 30, n_final: int = 10,
                   device="cuda") -> Dict:
    """Fig. 4 at one m/n: ``rounds`` rounds of K clients, E local steps
    at lr 0.5 (the ``mean`` transport, f32 downlink), 10 sampled
    networks every ``rounds // 5`` rounds, ``n_final`` at the end."""
    dev = resolve_device(device)
    ds = _dataset()
    acc = _acc_fn(ds, dev)
    zspecs, state = _setup(dims, compression, d=10, seed=1, device=dev)
    stream = client_batch_stream(iid_client_split(ds, K, seed=0), 64, E,
                                 seed=0)
    cfg = FederatedConfig(num_clients=K, local_steps=E, local_lr=0.5)
    words = _words(0, rounds)
    curve = []
    for r in range(rounds):
        xs, ys = next(stream)
        state, _ = federated_round(
            zspecs, state, mlp_loss, {"x": torch.from_numpy(xs).to(dev),
                                      "y": torch.from_numpy(ys).to(dev)},
            words[r], cfg, device=dev)
        if (r + 1) % max(rounds // 5, 1) == 0:
            ms, _ = evaluate(zspecs, state, acc, _words(5, 10), device=dev)
            curve.append(round(ms, 4))
    ms, mstd = evaluate(zspecs, state, acc, _words(5, n_final), device=dev)
    wire = {r_["strategy"]: r_["uplink_bytes_per_client"]
            for r_ in wire_table(zspecs, K)}
    return {"bench": "fig4_federated", "compression": compression,
            "final_sampled_acc": ms, "sampled_std": mstd, "curve": curve,
            "client_savings": 32.0 * zspecs.compression,
            "uplink_bytes_per_client": wire}


def _federated_grid(quick, device) -> Grid:
    return [(f"m/n={comp}", lambda comp=comp: [federated_cell(
        comp, dims=SMALL_DIMS if quick else MNISTFC_DIMS, K=10,
        E=40 if quick else 100, rounds=30 if quick else 100,
        n_final=10 if quick else 100, device=device)])
        for comp in (1, 8, 32)]


def run_federated(quick: bool = True, *, device="cuda") -> List[Dict]:
    return _rows(_federated_grid(quick, device))


# ---------------------------------------------------------------------------
# Wire formats: bytes a round per transport, and bit-exactness
# ---------------------------------------------------------------------------

def wire_formats_cell(compression: float, *, K: int = 4, E: int = 2,
                      device="cuda") -> List[Dict]:
    """One round per registered transport on the same inputs and word.
    Raises unless the aggregated scores are identical by bits across the
    transports (they differ only in wire format); reports each one's
    exact byte accounting."""
    dev = resolve_device(device)
    ds = _dataset()
    zspecs, state = _setup(SMALL_DIMS, compression, d=10, seed=0, device=dev)
    xs, ys = next(client_batch_stream(iid_client_split(ds, K, seed=0), 64, E,
                                      seed=0))
    batch = {"x": torch.from_numpy(xs).to(dev),
             "y": torch.from_numpy(ys).to(dev)}
    word = _words(0, 1)[0]
    rows, scores = [], {}
    for row in wire_table(zspecs, K):
        cfg = FederatedConfig(num_clients=K, local_steps=E, local_lr=0.5,
                              aggregate=row["strategy"])
        t0 = time.perf_counter()
        new_state, met = federated_round(zspecs, state, mlp_loss, batch,
                                         word, cfg, device=dev)
        loss = float(met["loss"])  # waits for the round's last kernel
        scores[row["strategy"]] = new_state["scores"]
        # the f32 metric against the exact host accounting
        if not np.isclose(float(met["uplink_bytes_per_client"]),
                          float(row["uplink_bytes_per_client"]), rtol=1e-6):
            raise AssertionError(
                f"{row['strategy']}: metered uplink "
                f"{float(met['uplink_bytes_per_client'])} against "
                f"{row['uplink_bytes_per_client']}")
        rows.append({**row, "bench": "wire_formats",
                     "compression": compression, "loss": loss,
                     "round_s": time.perf_counter() - t0})
    base = scores["mean_f32"]
    for name, sc in scores.items():
        for p in base:
            if not torch.equal(base[p].view(torch.int32),
                               sc[p].view(torch.int32)):
                raise AssertionError(
                    f"{name} not bit-identical to mean_f32 at {p}")
    return rows


def _wire_formats_grid(quick, device) -> Grid:
    return [(f"m/n={comp}", lambda comp=comp: wire_formats_cell(
        comp, K=4, E=2 if quick else 10, device=device))
        for comp in ([8] if quick else [1, 8, 32])]


def run_wire_formats(quick: bool = True, *, device="cuda") -> List[Dict]:
    return _rows(_wire_formats_grid(quick, device))


# ---------------------------------------------------------------------------
# Downlink codecs: the accuracy / downlink-bits trade-off
# ---------------------------------------------------------------------------

def downlink_cell(codec: str, schedule: str = "constant", *, K: int = 4,
                  E: int = 10, rounds: int = 10, n_eval: int = 10,
                  device="cuda") -> Dict:
    """One federated run (psum_u32, SMALL at m/n = 8) carrying ``codec``'s
    words, at a constant width or under a ``cosine`` (over ``rounds``) or
    ``frontier`` schedule from 2 bits: final sampled accuracy against
    the realized (metered) downlink bytes."""
    dev = resolve_device(device)
    ds = _dataset()
    acc = _acc_fn(ds, dev)
    zspecs, state = _setup(SMALL_DIMS, 8, d=10, seed=1, device=dev)
    extra = {}
    if schedule != "constant":
        extra = {"downlink_schedule": schedule, "schedule_b_min": 2}
        if schedule == "cosine":
            extra["schedule_rounds"] = rounds
    cfg = FederatedConfig(num_clients=K, local_steps=E, local_lr=0.5,
                          aggregate="psum_u32", downlink=codec, **extra)
    state = encode_state(zspecs, cfg, state, device=dev)
    stream = client_batch_stream(iid_client_split(ds, K, seed=0), 64, E,
                                 seed=0)
    xs, ys = zip(*(next(stream) for _ in range(rounds)))
    batches = {"x": torch.from_numpy(np.stack(xs)).to(dev),
               "y": torch.from_numpy(np.stack(ys)).to(dev)}
    state, mets = federated_fit(zspecs, state, mlp_loss, batches,
                                _words(0, rounds), cfg, device=dev)
    ms, mstd = evaluate(zspecs, state, acc, _words(5, n_eval), carried=codec,
                        device=dev)
    per_round = _host(mets["downlink_bytes_per_client"]).astype(np.float64)
    rep = round_wire_report(zspecs, cfg.aggregate, K, downlink=codec)
    return {
        "bench": "downlink_tradeoff", "codec": codec, "schedule": schedule,
        "K": K, "rounds": rounds, "final_sampled_acc": ms,
        "sampled_std": mstd,
        "final_loss": float(_host(mets["loss"])[-1]),
        # realized bytes: a scheduled round pays its width's lanes
        "downlink_bytes_per_client": float(per_round[-1]),
        "downlink_bytes_cumulative": float(per_round.sum()),
        "downlink_vs_f32": rep["downlink_vs_f32"],
    }


def _downlink_grid(quick, device) -> Grid:
    kw = dict(K=4, E=10 if quick else 40, rounds=10 if quick else 50,
              device=device)
    grid = [(name, "constant") for name in codec_names(include_aliases=False)]
    grid += [(name, schedule) for schedule in ("cosine", "frontier")
             for name in ("u8", "packed4")]
    return [(f"{name} {schedule}", lambda name=name, schedule=schedule: [
        downlink_cell(name, schedule, **kw)]) for name, schedule in grid]


def run_downlink_tradeoff(quick: bool = True, *, device="cuda") -> List[Dict]:
    return _rows(_downlink_grid(quick, device))


# ---------------------------------------------------------------------------
# Heterogeneity: accuracy against Dirichlet beta, per downlink codec
# ---------------------------------------------------------------------------

def heterogeneity_inputs(beta: float, codec: str, *, N: int = 8, K: int = 4,
                         E: int = 10, rounds: int = 10) -> Dict:
    """The numpy inputs of one heterogeneity run: a Dirichlet population
    of N unequal clients, a cohort of K a round (``ClientPopulation``,
    sample-count weights), the streaming fold in chunks of K // 2."""
    ds = _dataset()
    clients, hist = dirichlet_client_split(ds, N, beta=beta, seed=0)
    pop = ClientPopulation(N, sample_counts=tuple(int(s)
                                                  for s in hist.sum(axis=1)),
                           seed=0)
    zspecs, arrays = setup_arrays(SMALL_DIMS, 8, 10, seed=1)
    cfg = FederatedConfig(num_clients=K, local_steps=E, local_lr=0.5,
                          aggregate="psum_u32", downlink=codec,
                          stream_chunk=max(K // 2, 1))
    stream = cohort_batch_stream(clients, pop, K, 64, E, seed=0)
    items = [next(stream) for _ in range(rounds)]
    return {"zspecs": zspecs, "arrays": arrays, "cfg": cfg,
            "client_ids": np.stack([it[0] for it in items]),
            "weights": np.stack([it[1] for it in items]),
            "batches": {"x": np.stack([it[2] for it in items]),
                        "y": np.stack([it[3] for it in items])},
            "words": _words(0, rounds)}


def heterogeneity_fit(inputs: Dict, *, device="cuda"):
    """The run's rounds through ``federated_fit``: (state', metrics)."""
    dev = resolve_device(device)
    zspecs, cfg = inputs["zspecs"], inputs["cfg"]
    state = encode_state(zspecs, cfg, inputs["arrays"], device=dev)
    batches = {n: torch.from_numpy(v).to(dev)
               for n, v in inputs["batches"].items()}
    return federated_fit(zspecs, state, mlp_loss, batches, inputs["words"],
                         cfg, client_ids=inputs["client_ids"],
                         weights=inputs["weights"], device=dev)


def heterogeneity_cell(beta: float, codec: str, *, N: int = 8, K: int = 4,
                       E: int = 10, rounds: int = 10, n_eval: int = 10,
                       device="cuda") -> Dict:
    dev = resolve_device(device)
    inputs = heterogeneity_inputs(beta, codec, N=N, K=K, E=E, rounds=rounds)
    zspecs, cfg = inputs["zspecs"], inputs["cfg"]
    state, mets = heterogeneity_fit(inputs, device=dev)
    ms, mstd = evaluate(zspecs, state, _acc_fn(_dataset(), dev),
                        _words(5, n_eval), carried=codec, device=dev)
    rep = round_wire_report(zspecs, cfg.aggregate, K, downlink=codec)
    return {
        "bench": "heterogeneity", "beta": beta, "codec": codec, "N": N,
        "K": K, "rounds": rounds, "final_sampled_acc": ms,
        "sampled_std": mstd, "final_loss": float(_host(mets["loss"])[-1]),
        "downlink_bytes_per_client": rep["downlink_bytes_per_client"],
        "downlink_vs_f32": rep["downlink_vs_f32"],
    }


def _heterogeneity_grid(quick, device) -> Grid:
    N, K, E = (8, 4, 10) if quick else (50, 10, 40)
    return [(f"beta={beta} {name}", lambda beta=beta, name=name: [
        heterogeneity_cell(beta, name, N=N, K=K, E=E,
                           rounds=10 if quick else 50, device=device)])
        for beta in ([0.1, 1.0] if quick else [0.05, 0.1, 0.5, 1.0, 10.0])
        for name in codec_names(include_aliases=False)]


def run_heterogeneity(quick: bool = True, *, device="cuda") -> List[Dict]:
    return _rows(_heterogeneity_grid(quick, device))


# ---------------------------------------------------------------------------
# §3.3 / Table 4: sensitivity of sampled against regular training
# ---------------------------------------------------------------------------

def sensitivity_cell(mode: str, *, steps: int = 800,
                     taus: Sequence[float] = (0.01, 0.2, 0.5),
                     n_pert: int = 5, device="cuda") -> List[Dict]:
    """Train SMALL at m/n = 2, d = 5 in ``mode`` (``sample``: the rows
    labelled sampled; ``continuous``: regular), then perturb the scores
    on C_tau and read the expected network's accuracy."""
    dev = resolve_device(device)
    ds = _dataset()
    acc = _acc_fn(ds, dev)
    label = {"sample": "sampled", "continuous": "regular"}[mode]
    zspecs, state = _setup(SMALL_DIMS, 2.0, 5, seed=0, device=dev)
    state, _ = _train(zspecs, state, ds, steps, 1e-2, mode=mode, device=dev)
    with torch.no_grad():
        base = float(acc(sample_weights(zspecs, state, _words(3, 1)[0],
                                        mode="continuous", device=dev)))
    rows = []
    for tau in taus:
        sens, devs, accs = [], [], []
        for i in range(n_pert):
            pert, eps_sq = {}, 0.0
            for path, s in state["scores"].items():
                noise = np.random.RandomState(
                    [100 + i, zspecs.specs[path].tensor_id]).standard_normal(
                        s.shape[0]).astype(np.float32)
                pert[path], eps = perturb_nontrivial(
                    s, torch.from_numpy(noise).to(dev), tau)
                eps_sq += float(torch.sum(eps**2))
            eps_norm = np.sqrt(eps_sq)
            with torch.no_grad():
                a = float(acc(sample_weights(
                    zspecs, {"scores": pert, "dense": state["dense"]},
                    _words(4, 1)[0], mode="continuous", device=dev)))
            accs.append(a)
            sens.append(abs(base - a) / max(base, 1e-9))
            devs.append(abs(base - a) / max(eps_norm, 1e-9))
        rows.append({
            "bench": "table4_sensitivity", "training": label, "tau": tau,
            "base_acc": base, "avg_acc": float(np.mean(accs)),
            "avg_sensitivity": float(np.mean(sens)),
            "avg_deviation": float(np.mean(devs)),
        })
    return rows


def _sensitivity_grid(quick, device) -> Grid:
    return [(mode, lambda mode=mode: sensitivity_cell(
        mode, steps=800 if quick else 4000, n_pert=5 if quick else 10,
        device=device)) for mode in ("sample", "continuous")]


def run_sensitivity(quick: bool = True, *, device="cuda") -> List[Dict]:
    return _rows(_sensitivity_grid(quick, device))


# ---------------------------------------------------------------------------
# App. A / Fig. 5: the integrality gap against the initialisation
# ---------------------------------------------------------------------------

def integrality_cell(beta: tuple, *, steps: int = 800, n_samples: int = 10,
                     device="cuda") -> Dict:
    """App. A's continuous model (w = Q p trained directly, no sampling)
    from a Beta(a, b) init: expected, sampled and discretized accuracy."""
    dev = resolve_device(device)
    ds = _dataset()
    acc = _acc_fn(ds, dev)
    zspecs, state = _setup(SMALL_DIMS, 2.0, 5, seed=0, beta=beta, device=dev)
    state, _ = _train(zspecs, state, ds, steps, 1e-2, mode="continuous",
                      device=dev)
    exp_acc, _ = evaluate(zspecs, state, acc, mode="continuous", device=dev)
    samp_acc, samp_std = evaluate(zspecs, state, acc,
                                  _words(5, n_samples), device=dev)
    disc_acc, _ = evaluate(zspecs, state, acc, mode="discretize", device=dev)
    return {"bench": "fig5_integrality", "beta": beta,
            "expected_acc": exp_acc, "sampled_acc": samp_acc,
            "sampled_std": samp_std, "discretized_acc": disc_acc,
            "integrality_gap": exp_acc - samp_acc}


def _integrality_grid(quick, device) -> Grid:
    betas = [(0.1, 0.1), (1.0, 1.0)] if quick else [
        (0.05, 0.05), (0.1, 0.1), (0.5, 0.5), (1.0, 1.0), (2.0, 2.0)]
    return [(f"beta={beta}", lambda beta=beta: [integrality_cell(
        beta, steps=800 if quick else 3000, n_samples=10 if quick else 100,
        device=device)]) for beta in betas]


def run_integrality(quick: bool = True, *, device="cuda") -> List[Dict]:
    return _rows(_integrality_grid(quick, device))


# ---------------------------------------------------------------------------
# App. B.1 / Fig. 6: against Zhou et al. (d = 1, n = m supermask)
# ---------------------------------------------------------------------------

def zhou_cell(label: str, compression: float, d: int, *, dims=SMALL_DIMS,
              steps: int = 800, n_samples: int = 10, device="cuda") -> Dict:
    """Local zampling at (m/n, d): mean sampled accuracy and the best of
    ``n_samples`` sampled masks (the paper reports the best of 100)."""
    dev = resolve_device(device)
    ds = _dataset()
    acc = _acc_fn(ds, dev)
    zspecs, state = _setup(dims, compression, d, seed=0, device=dev)
    state, _ = _train(zspecs, state, ds, steps, 1e-2, device=dev)
    ms, mstd = evaluate(zspecs, state, acc, _words(5, n_samples), device=dev)
    with torch.no_grad():
        best = max(float(acc(sample_weights(zspecs, state, w, device=dev)))
                   for w in _words(6, n_samples))
    return {"bench": "fig6_zhou", "method": label, "d": d,
            "mean_sampled_acc": ms, "std": mstd, "best_mask_acc": best}


def _zhou_grid(quick, device) -> Grid:
    configs = [("zhou_d1_nm", 1.0, 1)] + [
        (f"zampling_d{d}", 1.0, d) for d in ([4, 16] if quick
                                             else [2, 4, 16, 256])]
    return [(label, lambda label=label, comp=comp, d=d: [zhou_cell(
        label, comp, d, dims=SMALL_DIMS if quick else MNISTFC_DIMS,
        steps=800 if quick else 4000, n_samples=10 if quick else 100,
        device=device)]) for label, comp, d in configs]


def run_zhou_comparison(quick: bool = True, *, device="cuda") -> List[Dict]:
    return _rows(_zhou_grid(quick, device))


_GRIDS = {
    "comm_savings_table": lambda quick, device: [("", comm_savings_table)],
    "run_local_compression": _local_compression_grid,
    "run_federated": _federated_grid,
    "run_wire_formats": _wire_formats_grid,
    "run_downlink_tradeoff": _downlink_grid,
    "run_heterogeneity": _heterogeneity_grid,
    "run_sensitivity": _sensitivity_grid,
    "run_integrality": _integrality_grid,
    "run_zhou_comparison": _zhou_grid,
}


def experiment_cells(name: str, quick: bool = True, *,
                     device="cuda") -> Grid:
    """The cells of one of the nine functions at its grid, in its order:
    (label, thunk giving the cell's rows).  The function's rows are its
    cells' rows, concatenated."""
    if name not in _GRIDS:
        raise ValueError(f"unknown experiment {name!r}; known: "
                         f"{', '.join(_GRIDS)}")
    return _GRIDS[name](quick, device)
