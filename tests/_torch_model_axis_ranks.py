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


# ---------------------------------------------------------------------------
# the other families' partitioned consumers (test_torch_model_axis_families)
# ---------------------------------------------------------------------------

def moe_ffn_config():
    """The reduced mixtral-8x7b with 3 experts: on a model axis of 2
    ``param_spec`` splits its experts on F and its router on D."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch("mixtral-8x7b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            num_experts=3))


def family_config(name: str):
    """A case's config: an arch at ``reduced()`` (f32), or ``moe-ffn``."""
    from repro_torch.configs import get_arch

    return moe_ffn_config() if name == "moe-ffn" else get_arch(name).reduced()


def family_specs(cfg, mesh: Mesh, zc: dict):
    """The config's specs with each zampled leaf's major axis where
    ``param_spec`` puts ``mesh``'s model axis, aligned to its size."""
    from repro_torch.models.model import param_template

    def plan(path, shape):
        return model_axis_of(param_spec(path, shape, mesh))

    return build_specs(param_template(cfg), ZamplingConfig(
        **zc, shard_align=mesh.axis_size("model")), shard_plan_fn=plan)


def family_batch(cfg, rng, b: int, s: int, lead=(1,)):
    """Token ids (and, for the enc-dec, encoder frames) of ``lead``
    clients (local steps), labels the tokens."""
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (*lead, b, s)))
    batch = {"tokens": toks, "labels": toks}
    if cfg.family in ("encdec", "audio"):
        batch["enc_embeds"] = torch.from_numpy(rng.randn(
            *lead, b, s // 4, cfg.d_model).astype(np.float32))
    return batch


def _products_equal(zs, axis, rng, b: int):
    """Whether, at the column blocks' shapes of ``zs`` on ``axis``, a
    column block's products (forward ``x @ W``, backward ``x^T @ g``)
    equal the whole products' columns: the precondition of holding a
    partitioned forward to the whole one by bits."""
    out = []
    for p, spec in zs.specs.items():
        shape = zs.template[p].shape
        if spec.shard_count == 1 or spec.major_axis != len(shape) - 1:
            continue
        d_in, d_out = shape[-2], shape[-1]
        x = torch.from_numpy(rng.randn(b, d_in).astype(np.float32))
        w = torch.from_numpy(rng.randn(d_in, d_out).astype(np.float32))
        g = torch.from_numpy(rng.randn(b, d_out).astype(np.float32))
        out.append(torch.equal(_block_of(x @ w, 1, axis),
                               x @ _block_of(w, 1, axis))
                   and torch.equal(_block_of(x.t() @ g, 1, axis),
                                   x.t() @ _block_of(g, 1, axis)))
    return out


def family_step(name: str, zc: dict, axis, seed: int = 0, b: int = 2,
                s: int = 16):
    """One local step of one client of the case ``name`` (the loss at
    the round's draw, then the gradients of the scores and dense
    leaves), on the data axis alone (whole leaves) and through the
    partitioned consumers on the model group ``axis``: the losses, each
    sharded leaf's (whole gradient's slice, slice's gradient), each
    dense leaf's gradients, the collectives and whole-leaf gathers of
    the partitioned step, the whole leaves and the batch (for JAX's
    ``loss_fn``), and the column products' precondition."""
    from repro_torch.core.zampling import MaskProgram, shard_slice
    from repro_torch.models.model import client_axis, init_dense, loss_fn

    cfg = family_config(name)
    mesh = Mesh(("data", "model"), (1, axis.size))
    zs = family_specs(cfg, mesh, zc)
    rng = np.random.RandomState(seed)
    scores = {p: torch.from_numpy(rng.rand(sp.n).astype(np.float32))
              for p, sp in zs.specs.items()}
    dense = {p: torch.from_numpy(v)
             for p, v in init_dense(cfg, zs.dense_paths, seed).items()}
    batch = family_batch(cfg, rng, b, s)
    program = MaskProgram(zs)
    word = 1000 + seed

    def step(sc, row_sharding):
        leaves = {p: v.clone().requires_grad_(True)
                  for p, v in {**sc, **dense}.items()}
        params = program.weights({p: leaves[p] for p in zs.specs},
                                 {p: leaves[p] for p in zs.dense_paths},
                                 word, None, row_sharding, blocks=True)
        loss = loss_fn(cfg, client_axis(params), batch)[0]
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return loss.detach(), dict(zip(leaves, grads)), params

    ref, ref_g, whole = step(scores, None)
    cut = {p: shard_slice(sp, axis) for p, sp in zs.specs.items()}
    shardmap.reset_counts()
    got, got_g, mine = step({p: v[cut[p][0]:cut[p][0] + cut[p][1]]
                             for p, v in scores.items()}, axis)
    counts = (dict(shardmap.COUNTS), dict(shardmap.GATHERED))
    routing = (None if cfg.moe is None else _routing(
        cfg, whole["blocks/moe/router"], mine["blocks/moe/router"], rng,
        b * s))

    def npy(g, like):
        return (torch.zeros_like(like) if g is None else g).numpy()

    return {
        "loss": (ref.numpy(), got.numpy()),
        "scores": {p: (npy(ref_g[p], scores[p])[c0:c0 + n],
                       npy(got_g[p], scores[p][c0:c0 + n]))
                   for p, (c0, n) in cut.items()},
        "dense": {p: (npy(ref_g[p], dense[p]), npy(got_g[p], dense[p]))
                  for p in zs.dense_paths},
        "counts": counts,
        "whole": {p: v.detach().numpy() for p, v in whole.items()},
        "batch": {n: v[0].numpy() for n, v in batch.items()},
        "products_equal": _products_equal(zs, axis, rng, b * s),
        "routing": routing,
    }


def _routing(cfg, whole, block, rng, t: int):
    """The first layer's MoE routing of ``t`` random tokens from the whole
    router and from this rank's router (a ``Block``, or the replicated
    leaf): whether the f32 logits, and then the dispatch, the combine,
    the probabilities and the picks, are the same bits, and the logits'
    largest difference relative to their largest magnitude."""
    from repro_torch.comm.shardmap import Block
    from repro_torch.models import moe

    x = torch.from_numpy(rng.randn(1, 1, t, cfg.d_model).astype(np.float32))
    with torch.no_grad():  # the first layer's, as one client's
        want = moe._router_logits(x, whole[:1].detach(), None)
        if isinstance(block, Block):
            one = block.unbind(0)[0].lead()
            block = Block(one.t.detach(), one.dim, one.axis, one.path,
                          one.front)
        else:
            block = block[:1].detach()
        got = moe._router_logits(x, block, None)
        same = all(torch.equal(a, b) for a, b in zip(
            moe._dispatch(want, cfg.moe, x.dtype),
            moe._dispatch(got, cfg.moe, x.dtype)))
    return {"logits_equal": torch.equal(want, got), "routing_equal": same,
            "logits_err": float((want - got).abs().max()
                                / want.abs().max())}


def family_grid(name: str, zc: dict, axes, seed: int = 0, b: int = 2,
                s: int = 16):
    """One round (one local step) of the case ``name`` on a grid
    (``axes``: this rank's data and model groups; a client a data
    index), through the partitioned consumers, then on the data-axis
    ranks alone (the model index 0 of each data index, whole leaves):
    each rank's new scores (its slice; every slice for a whole rank),
    dense leaves and loss, and the grid round's collectives and
    whole-leaf gathers."""
    from repro_torch.core.federated import FederatedConfig
    from repro_torch.core.zampling import init_state
    from repro_torch.models.model import client_axis, init_dense, loss_fn

    cfg = family_config(name)
    grid = Mesh(("data", "model"), (axes.data.size, axes.model.size))
    zs = family_specs(cfg, grid, zc)
    rng = np.random.RandomState(seed)
    scores = {p: rng.rand(sp.n).astype(np.float32)
              for p, sp in zs.specs.items()}
    state = init_state(zs, scores, init_dense(cfg, zs.dense_paths, seed),
                       device="cpu")
    batch = {n: v[axes.data.index] for n, v in family_batch(
        cfg, rng, b, s, lead=(axes.data.size, 1)).items()}
    fcfg = FederatedConfig(num_clients=axes.data.size, local_steps=1,
                           local_lr=0.05)

    def loss(params, bb):  # the LM loss takes a client axis
        return loss_fn(cfg, client_axis(params),
                       {n: v[None] for n, v in bb.items()})[0]

    def run(st, model, group):
        new, met = fed.sharded_client_update(
            zs, st, loss, batch, 7 + seed, fcfg, group=group,
            row_sharding=model, device="cpu")
        return {"scores": {p: v.numpy() for p, v in new["scores"].items()},
                "dense": {p: v.numpy() for p, v in new["dense"].items()},
                "loss": float(met["loss"])}

    m = axes.model.index
    shardmap.reset_counts()
    out = {"data": axes.data.index, "model": m,
           "grid": run(convert.to_model_rank(zs, state, m, axes.model.size),
                       axes.model, axes.data.group)}
    out["counts"] = (dict(shardmap.COUNTS), dict(shardmap.GATHERED))
    if m == 0:
        whole = run(state, None, axes.data.group)
        out["data_axis"] = whole
    return out


FAMILY_CASES = {  # name: min_size, each case's zampled leaves
    "olmoe-1b-7b": 1024,  # the router (2, 256, 4): a column block over E
    "mamba2-1.3b": 1024,  # A_log, D, dt_bias replicated; conv taps whole
    "moe-ffn": 1024,  # the router (2, 256, 3): a row block over D
    "zamba2-7b": 32,  # A_log, D, dt_bias blocks of heads; ln gathered
    "seamless-m4t-medium": 1024,
}
FAMILY_GROUPS = (("olmoe-1b-7b", "mamba2-1.3b", "moe-ffn"),
                 ("zamba2-7b", "seamless-m4t-medium"))
GRID_CASE = "zamba2-7b"


def family_zc(name: str, zc: dict) -> dict:
    return {**zc, "min_size": FAMILY_CASES[name]}


def rank_families(zc, axes):
    """``test_torch_model_axis_families.py``'s ranks, a 2 x 2 grid: each
    data index's model group runs its share of the cases' local steps
    (``family_step``), then the grid runs a round of GRID_CASE against
    its data-axis ranks (``family_grid``)."""
    torch.set_num_threads(1)
    out = {n: family_step(n, family_zc(n, zc), axes.model)
           for n in FAMILY_GROUPS[axes.data.index]}
    out["grid"] = family_grid(GRID_CASE, family_zc(GRID_CASE, zc), axes)
    return out
