"""Rank-side checks of ``test_torch_model_axis.py``.

``comm.shardmap.run_ranks`` starts each rank with ``spawn``, which
imports the rank function by name: it lives here, in a module that
imports torch and the port but not JAX, so a rank starts quickly.  Each
function returns numpy arrays and Python numbers only.
"""

import numpy as np
import torch

from repro_torch import convert
from repro_torch.comm import protocol
from repro_torch.comm.shardmap import gather_major
from repro_torch.core import federated as fed
from repro_torch.core.sampling import as_word, fold_word
from repro_torch.core.zampling import ZamplingConfig, build_specs, state_to
from repro_torch.fault import FaultPlan
from repro_torch.launch.mesh import Mesh, mesh_axes
from repro_torch.launch.sharding import model_axis_of, param_spec
from repro_torch.models.mlp import SMALL_DIMS, mlp_loss, mlp_template

CPU = torch.device("cpu")


def grid_specs(zc: dict, mesh: Mesh):
    """SMALL_DIMS' specs with each leaf's major axis where ``param_spec``
    puts the mesh's model axis, aligned to its size."""
    ms = mesh.axis_size("model")

    def plan(path, shape):
        return model_axis_of(param_spec(path, shape, mesh))

    return build_specs(mlp_template(SMALL_DIMS),
                       ZamplingConfig(**zc, shard_align=ms),
                       shard_plan_fn=plan)


def _np_state(st):
    return {part: {p: v.numpy() for p, v in st[part].items()}
            for part in ("scores", "dense")}


def _np_metrics(met):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in met.items()}


def _tensors(batch):
    return {n: torch.from_numpy(np.ascontiguousarray(v))
            for n, v in batch.items()}


def rank_grid(setup, axes):
    """Every rank-side check on a 2 x 2 grid (``axes``: this rank's data
    and model groups), then on the same ranks as one model group of 4:
    its slices of a round and of a faulted round on the grid, a gathered
    leaf and its cotangent, and a stacked K=3 round on
    the model group; rank 0 also runs the stacked references."""
    torch.set_num_threads(1)
    grid = Mesh(("data", "model"), (2, 2))
    zs = grid_specs(setup["zc"], grid)
    cfg = fed.FederatedConfig(**setup["fc"])
    d, m = axes.data.index, axes.model.index
    whole = state_to(zs, setup["state"], CPU)
    st = convert.to_model_rank(zs, whole, m, 2)
    key, r = setup["key"], setup["round"]
    rounds = [_tensors(b) for b in setup["batches"]]
    mine = {n: v[d] for n, v in rounds[0].items()}
    out = {"data": d, "model": m}

    new, met = fed.sharded_client_update(
        zs, st, mlp_loss, mine, key, cfg, group=axes.data.group,
        row_sharding=axes.model, round_index=r, device="cpu")
    out["round"] = (_np_state(new), _np_metrics(met))

    ids, w, plan = setup["ids"], setup["weights"], FaultPlan(**setup["plan"])
    new_f, met_f = fed.sharded_client_update(
        zs, st, mlp_loss, mine, key, cfg, group=axes.data.group,
        row_sharding=axes.model, round_index=r, client_id=ids[d],
        weight=w[d], faults=plan, device="cpu")
    out["faulted"] = (_np_state(new_f), _np_metrics(met_f))

    # gather_major: the blocks in rank order; the backward, this rank's
    # block of the cotangent
    blk = torch.arange(6.0).reshape(2, 3) + 10 * m
    blk.requires_grad_(True)
    whole_t = gather_major(blk, 0, axes.model)
    (whole_t * torch.arange(12.0).reshape(4, 3)).sum().backward()
    out["gather"] = (whole_t.detach().numpy(), blk.grad.numpy())

    if axes.data.index == 0 and m == 0:
        k2 = {n: v[:2] for n, v in rounds[0].items()}
        s_new, s_met = fed.federated_round(zs, whole, mlp_loss, k2, key, cfg,
                                           round_index=r, device="cpu")
        out["stacked"] = (_np_state(s_new), _np_metrics(s_met))
        s_f, s_fm = fed.federated_round(
            zs, whole, mlp_loss, k2, key, cfg, round_index=r,
            client_ids=ids, weights=w, faults=plan, device="cpu")
        out["stacked_faulted"] = (_np_state(s_f), _np_metrics(s_fm))
        # the data-axis-only round, one client at a time as its rank runs
        # it, combined as its collectives combine two clients
        per = [fed.local_update(zs, whole, mlp_loss,
                                {n: v[k] for n, v in k2.items()},
                                fold_word(as_word(key), as_word(r), k), cfg)
               for k in range(2)]
        psum = protocol.get_transport(cfg.aggregate)
        agg = {p: psum.aggregate_stacked_packed(
            torch.stack([u[0][p] for u in per]), s.n)
            for p, s in zs.specs.items()}
        out["per_client"] = (
            _np_state({"scores": fed._encode_scores(zs, cfg, agg, key, r),
                       "dense": {p: protocol.mean0(torch.stack(
                           [u[1][p] for u in per])) for p in zs.dense_paths}}),
            protocol.mean0(torch.stack([u[2] for u in per])).numpy())
        # the precondition of a bitwise comparison of the grid (one
        # client a data rank) with the stacked round
        x = k2["x"][:, 0]
        same = []
        for a, b in zip(SMALL_DIMS[:-1], SMALL_DIMS[1:]):
            wt = torch.from_numpy(np.random.RandomState(a).randn(
                2, a, b).astype(np.float32))
            y = torch.bmm(x, wt)
            same.append(all(torch.equal(y[k], x[k] @ wt[k]) for k in range(2)))
            x = torch.relu(y)
        out["bmm_equals_mm"] = same

    # the same four ranks as one model group of 4, K=3 clients stacked
    line = Mesh(("data", "model"), (1, 4))
    axes4 = mesh_axes(line)
    zs4 = grid_specs(setup["zc"], line)
    whole4 = state_to(zs4, setup["state4"], CPU)
    st4 = convert.to_model_rank(zs4, whole4, axes4.model.index, 4)
    new4, met4 = fed.federated_round(
        zs4, st4, mlp_loss, rounds[0], key, cfg, round_index=r,
        row_sharding=axes4.model, device="cpu")
    out["line"] = (_np_state(new4), _np_metrics(met4))
    if axes4.model.index == 0:
        s4, sm4 = fed.federated_round(zs4, whole4, mlp_loss, rounds[0], key,
                                      cfg, round_index=r, device="cpu")
        out["line_stacked"] = (_np_state(s4), _np_metrics(sm4))
    return out
