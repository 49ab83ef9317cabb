"""Rank-side checks of ``test_torch_model_axis.py``.

``comm.shardmap.run_ranks`` starts each rank with ``spawn``, which
imports the rank function by name: it lives here, in a module that
imports torch and the port but not JAX, so a rank starts quickly.  Each
function returns numpy arrays and Python numbers only.
"""

import numpy as np
import torch

from repro_torch import convert
from repro_torch.comm import protocol, shardmap
from repro_torch.comm.shardmap import gather_major
from repro_torch.core import federated as fed
from repro_torch.core.sampling import as_word, fold_word
from repro_torch.core.zampling import ZamplingConfig, build_specs, state_to
from repro_torch.fault import FaultPlan
from repro_torch.launch.mesh import Mesh, mesh_axes
from repro_torch.launch.sharding import model_axis_of, param_spec
from repro_torch.models.attention import FLASH_THRESHOLD
from repro_torch.models.mlp import (SMALL_DIMS, init_mlp_params, mlp_loss,
                                   mlp_template)

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


def lm_config(**kw):
    """The reduced qwen2-0.5b (2 layers, d_model 256, 4 heads, 2 KV heads
    of 64, vocab 512) in f32, with ``kw`` replaced."""
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("qwen2-0.5b").reduced(),
                               dtype="float32", **kw)


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
    its slices of a round (and its collectives) and of a faulted round
    and a frontier round on the grid, the partitioned MLP and reduced
    decoder against their unsharded selves, the frontier's widths from
    slices, a gathered leaf and its cotangent, and a stacked K=3 round
    and the reduced decoder on the model group; rank 0 also runs the
    stacked and data-axis references."""
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

    shardmap.reset_counts()
    new, met = fed.sharded_client_update(
        zs, st, mlp_loss, mine, key, cfg, group=axes.data.group,
        row_sharding=axes.model, round_index=r, device="cpu")
    out["round"] = (_np_state(new), _np_metrics(met))
    out["round_counts"] = (dict(shardmap.COUNTS), dict(shardmap.GATHERED))

    # the partitioned consumers against the unsharded ones at the test
    # size, and the frontier's widths on the grid
    out["mlp"] = mlp_blocks(axes.model)
    out["lm_grid"] = lm_blocks(lm_config(), axes.model)
    if d == 0:  # the blockwise attention on head blocks, one model group
        out["lm_flash"] = lm_blocks(lm_config(n_layers=1), axes.model, k=1,
                                    b=1, s=FLASH_THRESHOLD)
    out["frontier_widths"] = frontier_widths(zs, axes.model)
    cfg_f = fed.FederatedConfig(**setup["fc"], downlink_schedule="frontier")
    new_fr, _ = fed.sharded_client_update(
        zs, st, mlp_loss, mine, key, cfg_f, group=axes.data.group,
        row_sharding=axes.model, round_index=r, device="cpu")
    out["frontier"] = new_fr["downlink_b"].numpy()

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
        f_new, _ = fed.federated_round(zs, whole, mlp_loss, k2, key, cfg_f,
                                       round_index=r, device="cpu")
        out["frontier_stacked"] = f_new["downlink_b"].numpy()
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
    out["lm_line"] = lm_blocks(lm_config(), axes4.model)
    if axes4.model.index == 0:
        s4, sm4 = fed.federated_round(zs4, whole4, mlp_loss, rounds[0], key,
                                      cfg, round_index=r, device="cpu")
        out["line_stacked"] = (_np_state(s4), _np_metrics(sm4))
    return out


def _block_of(t, dim, axis):
    """This rank's block of a whole tensor along ``dim``."""
    size = t.shape[dim] // axis.size
    return t.narrow(dim, axis.index * size, size).contiguous()


REPLICATED = ("blocks/attn/bk", "blocks/attn/bv")  # dense at full width


def lm_blocks(cfg, axis, k=2, b=2, s=16, seed=0, device="cpu"):
    """The reduced decoder's K-client loss and every leaf's cotangent,
    unsharded and through the partitioned consumers on the model group
    ``axis``: each leaf ``param_spec`` splits (on a (1, ms) mesh) handed
    over as this rank's ``Block``, but for the k/v biases, replicated as
    full-width qwen2-0.5b's dense leaves are.  Returns the losses, each
    leaf's (whole cotangent's block, block's cotangent), the placements
    and the collectives of the partitioned step."""
    from repro_torch.comm import shardmap
    from repro_torch.comm.shardmap import Block
    from repro_torch.core.zampling import flatten
    from repro_torch.models.model import init_dense, loss_fn, param_template

    mesh = Mesh(("data", "model"), (1, axis.size))
    tmpl = dict(flatten(param_template(cfg)))
    rng = np.random.RandomState(seed)
    init = init_dense(cfg, list(tmpl), seed)
    whole = {p: torch.from_numpy(np.stack([init[p] * (1 + 0.1 * c)
                                           for c in range(k)])).to(device)
             for p in tmpl}
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (k, b, s + 1))).to(
        device)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    leaves = {p: v.clone().requires_grad_(True) for p, v in whole.items()}
    ref = loss_fn(cfg, leaves, batch)
    ref_g = dict(zip(leaves, torch.autograd.grad(ref.sum(),
                                                 list(leaves.values()))))
    dims = {p: None if p in REPLICATED else
            model_axis_of(param_spec(p, leaf.shape, mesh))
            for p, leaf in tmpl.items()}
    mine = {p: (_block_of(v, 1 + dims[p], axis) if dims[p] is not None
                else v.clone()).requires_grad_(True)
            for p, v in whole.items()}
    params = {p: Block(v, 1 + dims[p], axis, p, 1) if dims[p] is not None
              else v for p, v in mine.items()}
    shardmap.reset_counts()
    got = loss_fn(cfg, params, batch)
    got_g = dict(zip(mine, torch.autograd.grad(got.sum(),
                                               list(mine.values()))))
    counts = (dict(shardmap.COUNTS), dict(shardmap.GATHERED))
    return {"loss": (ref.detach().cpu().numpy(), got.detach().cpu().numpy()),
            "grads": {p: ((_block_of(ref_g[p], 1 + dims[p], axis)
                           if dims[p] is not None else ref_g[p]).cpu().numpy(),
                          got_g[p].cpu().numpy()) for p in tmpl},
            "dims": dims, "counts": counts, "layers": cfg.n_layers}


def mlp_blocks(axis, b=8, seed=0):
    """SMALL_DIMS' one-client loss and cotangents (the leaves as a rank of
    the sharded round holds them, no client axis), unsharded and with
    each kernel ``param_spec`` splits on a (1, ms) mesh handed over as
    this rank's ``Block``; and whether, at these shapes, a column block's
    products (forward ``x @ W``, backward ``x^T @ g``) equal the whole
    products' columns, the precondition of comparing by bits."""
    from repro_torch.comm import shardmap
    from repro_torch.comm.shardmap import Block

    mesh = Mesh(("data", "model"), (1, axis.size))
    rng = np.random.RandomState(seed)
    whole = {p: torch.from_numpy(v) for p, v in
             init_mlp_params(rng, SMALL_DIMS).items()}
    for p in whole:
        if p.endswith("bias"):
            whole[p] = torch.from_numpy(
                0.1 * rng.randn(*whole[p].shape).astype(np.float32))
    batch = {"x": torch.from_numpy(rng.rand(b, SMALL_DIMS[0]).astype(
        np.float32)), "y": torch.from_numpy(rng.randint(0, SMALL_DIMS[-1], b))}
    leaves = {p: v.clone().requires_grad_(True) for p, v in whole.items()}
    ref = mlp_loss(leaves, batch)
    ref_g = dict(zip(leaves, torch.autograd.grad(ref, list(leaves.values()))))
    dims = {p: model_axis_of(param_spec(p, tuple(v.shape), mesh))
            if p.endswith("kernel") else None for p, v in whole.items()}
    mine = {p: (_block_of(v, dims[p], axis) if dims[p] is not None
                else v.clone()).requires_grad_(True)
            for p, v in whole.items()}
    params = {p: Block(v, dims[p], axis, p) if dims[p] is not None else v
              for p, v in mine.items()}
    shardmap.reset_counts()
    got = mlp_loss(params, batch)
    got_g = dict(zip(mine, torch.autograd.grad(got, list(mine.values()))))
    counts = (dict(shardmap.COUNTS), dict(shardmap.GATHERED))
    same = []
    for i, (a, c) in enumerate(zip(SMALL_DIMS[:-1], SMALL_DIMS[1:])):
        if dims[f"layer{i}/kernel"] != 1:
            continue
        r = np.random.RandomState(a + c)
        x = torch.from_numpy(r.randn(b, a).astype(np.float32))
        w = torch.from_numpy(r.randn(a, c).astype(np.float32))
        g = torch.from_numpy(r.randn(b, c).astype(np.float32))
        same.append(torch.equal(_block_of(x @ w, 1, axis),
                                x @ _block_of(w, 1, axis))
                    and torch.equal(_block_of(x.t() @ g, 1, axis),
                                    x.t() @ _block_of(g, 1, axis)))
    return {"loss": (ref.detach().numpy(), got.detach().numpy()),
            "grads": {p: ((_block_of(ref_g[p], dims[p], axis)
                           if dims[p] is not None else ref_g[p]).numpy(),
                          got_g[p].numpy()) for p in whole},
            "dims": dims, "counts": counts, "products_equal": same}


def frontier_widths(zs, axis, seed=0):
    """The frontier's next widths from one aggregate, by this rank's
    slices summed over the model group and by the whole tensors."""
    from repro_torch.core.federated import _frontier_next_b
    from repro_torch.core.zampling import shard_slice

    cfg = fed.FederatedConfig(downlink="u8", downlink_schedule="frontier")
    rng = np.random.RandomState(seed)
    agg = {p: torch.from_numpy(rng.randint(0, 3, s.n).astype(np.float32)
                               / np.float32(2)) for p, s in zs.specs.items()}
    b = torch.tensor([2, 4, 6])[:len(zs.specs)]
    mine = {}
    for p, spec in zs.specs.items():
        c0, n = shard_slice(spec, axis)
        mine[p] = agg[p][c0:c0 + n]
    return (_frontier_next_b(zs, cfg, mine, b, axis).numpy(),
            _frontier_next_b(zs, cfg, agg, b).numpy())


def gpu_lm_blocks(ms, axes):
    """``lm_blocks`` on the card (the reduced decoder in f32, gloo
    carrying CUDA tensors through the host), on a model group of
    ``ms``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return lm_blocks(lm_config(), axes.model, device="cuda")
