"""Rank-side checks of ``test_torch_sharded.py``.

``comm.shardmap.run_ranks`` starts each rank with ``spawn``, which
imports the rank function by name: it lives here, in a module that
imports torch and the port but not JAX, so a rank starts quickly.
Each function returns numpy arrays and Python numbers only.
"""

import time

import numpy as np
import torch

from repro_torch.comm import protocol
from repro_torch.comm.bitpack import unpack_mask
from repro_torch.comm.shardmap import axis_index, axis_size
from repro_torch.core import federated as fed
from repro_torch.core.sampling import as_word, fold_word
from repro_torch.core.zampling import ZamplingConfig, build_specs, state_to
from repro_torch.kernels import ops, qz_reconstruct
from repro_torch.models.mlp import SMALL_DIMS, mlp_loss, mlp_template
from repro_torch.train import sharded_client_fit

CPU = torch.device("cpu")


def _np_state(st):
    return {part: {p: v.numpy() for p, v in st[part].items()}
            for part in ("scores", "dense")}


def _np_metrics(met):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in met.items()}


def _tensors(batch):
    return {n: torch.from_numpy(np.ascontiguousarray(v))
            for n, v in batch.items()}


def _counting_wrappers(counts):
    """Route ``kernels.ops`` to the kernel wrappers (which run their
    plain versions on CPU tensors) and count each wrapper's calls."""
    for name in qz_reconstruct.LAUNCHES:
        fn = getattr(qz_reconstruct, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        setattr(qz_reconstruct, name, counted)
    ops.resolve_impl = lambda impl, x: "cuda"


def rank_checks(setup):
    """Every rank-side check: this rank's word and upload, the
    collectives on it, a round under each transport, a round through
    the kernel wrappers, and a fit against sequential rounds; rank 0
    also runs the stacked round on the same inputs."""
    torch.set_num_threads(1)
    zs = build_specs(mlp_template(SMALL_DIMS), ZamplingConfig(**setup["zc"]))
    cfg = fed.FederatedConfig(**setup["fc"])
    st = state_to(zs, setup["state"], CPU)
    rank, world = axis_index(), axis_size()
    key, r = setup["key"], setup["round"]
    mine = _tensors({n: v[rank] for n, v in setup["batches"][0].items()})
    out = {"rank": rank, "world": world}

    word = fold_word(as_word(key), as_word(r), rank)
    out["word"] = word
    up, _, _ = fed.local_update(zs, st, mlp_loss, mine, word, cfg)
    out["upload"] = {p: v.numpy() for p, v in up.items()}
    psum, mean = (protocol.get_transport(t) for t in ("psum_u32", "mean"))
    out["agg"] = {p: {
        "packed": psum.aggregate_collective_packed(up[p], s.n).numpy(),
        "psum": psum.aggregate_collective(unpack_mask(up[p], s.n)).numpy(),
        "mean": mean.aggregate_collective(unpack_mask(up[p], s.n)).numpy()}
        for p, s in zs.specs.items()}

    new, met = fed.sharded_client_update(zs, st, mlp_loss, mine, key, cfg,
                                         round_index=r, device="cpu")
    out["round"] = (_np_state(new), _np_metrics(met))
    cfg_mean = fed.FederatedConfig(**{**setup["fc"], "aggregate": "mean"})
    new_m, met_m = fed.sharded_client_update(zs, st, mlp_loss, mine, key,
                                             cfg_mean, round_index=r,
                                             device="cpu")
    out["round_mean"] = (_np_state(new_m), _np_metrics(met_m))

    words = setup["fit_words"]
    rounds = [_tensors({n: v[rank] for n, v in b.items()})
              for b in setup["batches"]]
    fit_state, fit_met = sharded_client_fit(
        zs, st, mlp_loss, {n: torch.stack([b[n] for b in rounds])
                           for n in mine}, words, cfg, device="cpu")
    out["fit"] = (_np_state(fit_state), _np_metrics(fit_met))
    seq, seq_met = st, []
    for i, w in enumerate(words):
        seq, m = fed.sharded_client_update(zs, seq, mlp_loss, rounds[i], w,
                                           cfg, round_index=i, device="cpu")
        seq_met.append(_np_metrics(m))
    out["seq"] = (_np_state(seq), seq_met)

    if rank == 0:
        stacked = _tensors(setup["batches"][0])
        words_k = [fold_word(as_word(key), as_word(r), k)
                   for k in range(world)]
        s_up, _, _ = fed.local_update(zs, st, mlp_loss, stacked, words_k, cfg)
        out["stacked_upload"] = {p: v.numpy() for p, v in s_up.items()}
        s_new, s_met = fed.federated_round(zs, st, mlp_loss, stacked, key,
                                           cfg, round_index=r, device="cpu")
        out["stacked"] = (_np_state(s_new), _np_metrics(s_met))
        # the precondition of a bitwise comparison: at these shapes a
        # batched product equals the per-client one
        x = stacked["x"][:, 0]
        same = []
        for a, b in zip(SMALL_DIMS[:-1], SMALL_DIMS[1:]):
            w = torch.from_numpy(np.random.RandomState(a).randn(
                world, a, b).astype(np.float32))
            y = torch.bmm(x, w)
            same.append(all(torch.equal(y[k], x[k] @ w[k])
                            for k in range(world)))
            x = torch.relu(y)
        out["bmm_equals_mm"] = same

    # the same round through the kernel wrappers, counting their calls
    counts = {name: 0 for name in qz_reconstruct.LAUNCHES}
    _counting_wrappers(counts)
    new_k, _ = fed.sharded_client_update(zs, st, mlp_loss, mine, key, cfg,
                                         round_index=r, device="cpu")
    out["wrapper_calls"] = counts
    out["round_via_wrappers"] = _np_state(new_k)
    return out


def rank_fails_on_one():
    """Rank 1 raises; rank 0 waits in a collective it never completes."""
    if axis_index() == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.all_reduce(torch.zeros(1))
    return "unreachable"


def rank_sleeps(seconds):
    time.sleep(seconds)
    return "slept"
