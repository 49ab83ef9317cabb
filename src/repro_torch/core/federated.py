"""FEDERATED ZAMPLING, the full-participation round (paper §1.3).

The JAX package's ``core/federated.py``, slab path.  One round:

  1. the server broadcasts p(t), encoded by the downlink codec (the
     state carried between rounds IS the codec's wire words);
  2. each of the K clients decodes its own f32 score copy and takes E
     local SGD steps, a fresh mask drawn inside the forward kernel at
     every step (``MaskProgram.weights``);
  3. each client draws its upload z ~ Bern(f(s)) as n bits in wire
     lanes (``MaskProgram.upload``);
  4. the server averages the votes into p(t+1) through the transport
     and re-encodes it.

The JAX package runs the K clients under ``vmap``; here they are an
explicit leading axis: scores (K, n), dense leaves (K, ...), batches
(K, E, B, ...), and the loss function returns (K,) per-client losses.
The backward runs on the SUM of the K losses, so each client's
gradient is its own loss's (a mean would scale each by 1/K).

``sharded_client_update`` is the JAX package's body under
``shard_map``, one client per rank of a ``torch.distributed`` group
(``comm.shardmap``): each rank runs ``local_update`` on its one client
(no client axis: the K=1 kernels 7, 5 and 9), and the round's only
communication is the transport's collective over the uploads, an f32
all-reduce of the dense leaves and one of the loss.  Client k's words
are ``federated_round``'s, so the two drivers draw the same bits.

Draw words, as the JAX package derives them (``federated.py:891-893``,
``:398``, ``:413-414``, ``:513``): client k of round r trains at
``kw = fold_word(as_word(key), r, k)``, local step e draws at
``fold_word(kw, e)``, the upload at ``fold_word(kw, E)``, and the
server's encode dither is keyed by ``fold_word(as_word(key), r)``.

``mask_path="composed"`` runs the composed oracle: explicit
straight-through masks on the reconstruct kernels (kernel 3 forward,
kernel 6 backward) and the upload as ``pack_mask`` of the drawn mask;
it gives the fused round's state and loss bit for bit.  The
``continuous`` mode trains the expected network (kernels 3 and 6 on
the probabilities) and uploads the probabilities over ``mean_f32``;
``discretize`` trains the rounded network (kernel 3; a rounded mask
takes no gradient, so only the dense leaves move) and uploads its bits
over any transport.  Every transport (``mean_f32``, ``psum_u32``,
``allgather_packed``) and every codec (f32, u16, u8 words, the packed
sub-byte lanes) runs in both drivers; a packed codec's lanes are the
carried state.  Partial participation, streaming aggregation and the
downlink schedules raise ``NotImplementedError``: they come with later
slices, as does the sharded round's model axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..comm.downlink import get_codec
from ..comm.metering import round_wire_report
from ..comm.protocol import mean0, pmean, resolve_transport
from ..comm.shardmap import axis_index, axis_size
from ..device import as_tensor, resolve_device
from ..optim import Optimizer, sgd
from .sampling import as_word, as_words, fold_word
from .zampling import (MASK_MODES, MaskProgram, ZamplingSpecs,
                       infer_downlink, state_to, validate_carried)

# (params with a leading K axis, batch with a leading K axis) -> (K,)
LossFn = Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor]],
                  torch.Tensor]

_MASK_PATHS = ("fused", "composed")
DOWNLINK_SCHEDULES = ("constant", "cosine", "frontier")
WIRE_METRIC_KEYS = (
    "uplink_bytes_per_client",
    "uplink_bytes_round",
    "downlink_bytes_per_client",
    "downlink_bytes_round",
    "naive_uplink_bytes_per_client",
)


def _later(what: str):
    return NotImplementedError(f"{what} is not ported yet; it comes with "
                               "a later slice of the port")


@dataclass(frozen=True)
class FederatedConfig:
    """The JAX package's fields and defaults.  Values the port does not
    run yet raise: ``stream_chunk > 0`` and schedules other than
    ``constant``."""

    num_clients: int = 10
    local_steps: int = 1  # "epochs" per round in the paper (up to 100)
    local_lr: float = 0.1
    mode: str = "sample"
    aggregate: str = "mean"  # a comm.protocol transport name
    mask_path: str = "fused"
    downlink: str = "f32"  # a comm.downlink codec name
    min_clients: int = 1
    stream_chunk: int = 0
    downlink_schedule: str = "constant"
    schedule_b_min: int = 2
    schedule_rounds: int = 0
    frontier_threshold: float = 0.02

    def __post_init__(self):
        if self.min_clients < 1:
            raise ValueError(f"min_clients must be >= 1, got "
                             f"{self.min_clients}")
        if self.stream_chunk < 0:
            raise ValueError(f"stream_chunk must be >= 0 (0 = slab path), "
                             f"got {self.stream_chunk}")
        resolve_transport(self.aggregate)
        get_codec(self.downlink)
        if self.mode not in MASK_MODES:
            raise ValueError(f"unknown mask mode {self.mode!r}; valid "
                             f"modes: {', '.join(MASK_MODES)}")
        if self.mask_path not in _MASK_PATHS:
            raise ValueError(f"unknown mask_path {self.mask_path!r}; valid "
                             f"paths: {', '.join(_MASK_PATHS)}")
        if self.downlink_schedule not in DOWNLINK_SCHEDULES:
            raise ValueError(
                f"unknown downlink_schedule {self.downlink_schedule!r}; "
                f"valid schedules: {', '.join(DOWNLINK_SCHEDULES)}")
        if self.stream_chunk:
            raise _later("streaming aggregation (stream_chunk > 0)")
        if self.downlink_schedule != "constant":
            raise _later(f"downlink_schedule={self.downlink_schedule!r}")


def mask_program(zspecs: ZamplingSpecs, cfg: FederatedConfig,
                 impl: Optional[str] = None) -> MaskProgram:
    """The round's mask lifecycle; ``packed`` is the transport's."""
    transport = resolve_transport(cfg.aggregate, cfg.mode)
    return MaskProgram(zspecs, mode=cfg.mode,
                       fused=cfg.mask_path == "fused",
                       packed=transport.packed_wire, downlink=cfg.downlink,
                       impl=impl)


def encode_state(zspecs: ZamplingSpecs, cfg: FederatedConfig, state,
                 word=0, *, device="cuda") -> Dict[str, Any]:
    """An f32 score state (numpy or tensors) in ``cfg.downlink``'s wire
    words on ``device`` — what the rounds carry.  ``word`` keys the
    dither.  A state already carrying the codec (by dtype and, for a
    packed codec, lane count) passes through; one carrying another
    codec raises."""
    st = state_to(zspecs, state, resolve_device(device))
    codec = get_codec(cfg.downlink)
    try:
        validate_carried(zspecs, st["scores"], codec.name)
        return st
    except ValueError:
        pass
    carried = infer_downlink(st["scores"])
    if carried != "f32":
        raise ValueError(f"state is already encoded with downlink codec "
                         f"{carried!r}; decode_state it first before "
                         f"re-encoding as {codec.name!r}")
    w = as_word(word)
    return {"scores": {p: codec.encode(spec, st["scores"][p], w)
                       for p, spec in zspecs.specs.items()},
            "dense": st["dense"]}


def decode_state(zspecs: ZamplingSpecs, cfg: FederatedConfig, state, *,
                 device="cuda") -> Dict[str, Any]:
    """Wire-encoded round carry -> f32 score state (lossy inverse of
    ``encode_state``)."""
    st = state_to(zspecs, state, resolve_device(device))
    return {"scores": mask_program(zspecs, cfg).decode_scores(st["scores"]),
            "dense": st["dense"]}


def local_update(zspecs: ZamplingSpecs, state: Dict[str, Any],
                 loss_fn: LossFn, batches: Dict[str, torch.Tensor], words,
                 cfg: FederatedConfig, opt: Optional[Optimizer] = None, *,
                 impl: Optional[str] = None):
    """K clients' local round at once, or one client's: E score steps,
    then the upload.

    ``state``: the encoded broadcast (tensors on one device);
    ``words``: the K clients' draw words ``kw`` with ``batches``
    {name: (K, E, B, ...)}, or one client's word with {name: (E, B,
    ...)}.  Returns (uploads {path: (K, L) lanes, or (K, n) f32 masks on
    an f32 transport}, dense {path: (K, ...)}, (K,) mean losses over the
    E steps), without the K axis for one client: the JAX package's
    ``local_update`` as the sharded round runs it, on the K=1 kernels."""
    opt = opt or sgd(cfg.local_lr)
    program = mask_program(zspecs, cfg, impl)
    one = np.ndim(words) == 0
    kws = [words] if one else list(words)
    steps = cfg.local_steps
    lead = (steps,) if one else (len(kws), steps)
    for name, v in batches.items():
        if tuple(v.shape[:len(lead)]) != lead:
            raise ValueError(f"batch {name!r} has leading shape "
                             f"{tuple(v.shape[:len(lead)])}, expected "
                             f"{lead}")
    dev = next(iter(state["scores"].values())).device
    step_words = as_words([[fold_word(kw, e) for kw in kws]
                           for e in range(steps + 1)], dev)  # (E+1, K)
    scores0 = program.decode_scores(state["scores"])
    if one:
        step_words = step_words[:, 0]
    axis = lead[:-1]  # (K,), or () for one client
    trainable = {p: t.expand(*axis, *t.shape).clone()
                 for p, t in {**scores0, **state["dense"]}.items()}
    opt_state = opt.init(trainable)
    losses = []
    for e in range(steps):
        leaves = {p: t.detach().requires_grad_(True)
                  for p, t in trainable.items()}
        params = program.weights(
            {p: leaves[p] for p in zspecs.specs},
            {p: leaves[p] for p in zspecs.dense_paths}, step_words[e])
        loss_k = loss_fn(params, {n: v[e] if one else v[:, e]
                                  for n, v in batches.items()})
        # a rounded (discretize) mask takes no gradient: its scores get 0
        grads = [torch.zeros_like(leaves[p]) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(
                     loss_k.sum(), list(leaves.values()), allow_unused=True))]
        updates, opt_state = opt.update(dict(zip(leaves, grads)), opt_state,
                                        leaves)
        trainable = {p: leaves[p].detach() + updates[p] for p in leaves}
        losses.append(loss_k.detach())
    # one client's upload word goes to kernel 9 as a scalar
    up_word = fold_word(kws[0], steps) if one else step_words[steps]
    uploads = program.upload({p: trainable[p] for p in zspecs.specs},
                             up_word)
    dense = {p: trainable[p] for p in zspecs.dense_paths}
    return uploads, dense, torch.stack(losses).mean(0)


def _encode_scores(zspecs, cfg, agg, word: int, round_index: int):
    """Re-encode p(t+1) as the next broadcast, dither keyed by
    ``fold_word(word, round_index)``."""
    codec = get_codec(cfg.downlink)
    if not codec.quantized:
        return agg
    w = fold_word(word, round_index)
    return {p: codec.encode(spec, agg[p], w)
            for p, spec in zspecs.specs.items()}


def _full_participation_metrics(k: int) -> Dict[str, float]:
    return {"cohort_size": float(k), "num_participating": float(k),
            "num_dropped": 0.0, "num_stragglers": 0.0, "num_corrupt": 0.0,
            "num_duplicates": 0.0, "weight_sum": float(k),
            "round_skipped": 0.0}


def federated_round(zspecs: ZamplingSpecs, state: Dict[str, Any],
                    loss_fn: LossFn, client_batches, key,
                    cfg: FederatedConfig, opt: Optional[Optimizer] = None, *,
                    round_index=0, client_ids=None, weights=None,
                    faults=None, impl: Optional[str] = None,
                    device="cuda"):
    """One full-participation round over the K clients stacked on the
    batches' leading axis.  ``key`` is the round's uint32 draw word.
    Returns (state', metrics); state' carries ``cfg.downlink``'s words."""
    if client_ids is not None or weights is not None or faults is not None:
        raise _later("partial participation (client_ids/weights/faults)")
    dev = resolve_device(device)
    st = state_to(zspecs, state, dev)
    batches = {n: as_tensor(v, dev) for n, v in client_batches.items()}
    k = next(iter(batches.values())).shape[0]
    transport = resolve_transport(cfg.aggregate, cfg.mode)
    kw, r = as_word(key), as_word(round_index)
    words = [fold_word(kw, r, i) for i in range(k)]
    uploads, dense_all, losses = local_update(zspecs, st, loss_fn, batches,
                                              words, cfg, opt, impl=impl)
    if transport.packed_wire:
        agg = {p: transport.aggregate_stacked_packed(uploads[p], spec.n)
               for p, spec in zspecs.specs.items()}
    else:
        agg = {p: transport.aggregate_stacked(uploads[p])
               for p in zspecs.specs}
    rep = round_wire_report(zspecs, cfg.aggregate, k, mode=cfg.mode,
                            downlink=cfg.downlink)
    metrics = {"loss": mean0(losses),
               **{name: rep[name] for name in WIRE_METRIC_KEYS},
               **_full_participation_metrics(k)}
    new_state = {"scores": _encode_scores(zspecs, cfg, agg, kw, r),
                 "dense": {p: mean0(d) for p, d in dense_all.items()}}
    return new_state, metrics


def sharded_client_update(zspecs: ZamplingSpecs, state: Dict[str, Any],
                          loss_fn: LossFn, batches, key,
                          cfg: FederatedConfig,
                          opt: Optional[Optimizer] = None, *, group=None,
                          round_index=0, client_id=None, weight=None,
                          faults=None, impl: Optional[str] = None,
                          device="cuda"):
    """One full-participation round on this rank's client: the JAX
    package's ``sharded_client_update`` body, a client per rank of
    ``group`` (the default group when None).

    ``batches``: this client's {name: (E, B, ...)}; ``key``: the round's
    uint32 word, the same on every rank.  Rank k trains at
    ``fold_word(key, round_index, k)``, ``federated_round``'s client k.
    The uploads meet in the transport's collective; every rank re-encodes
    the mean at the replicated dither word and averages the dense leaves
    and the loss by ``pmean``, so every rank returns the same (state',
    metrics), K being the group's size."""
    if client_id is not None or weight is not None or faults is not None:
        raise _later("partial participation (client_id/weight/faults)")
    dev = resolve_device(device)
    st = state_to(zspecs, state, dev)
    batch = {n: as_tensor(v, dev) for n, v in batches.items()}
    transport = resolve_transport(cfg.aggregate, cfg.mode)
    kw, r = as_word(key), as_word(round_index)
    k = axis_size(group)
    upload, dense, loss = local_update(
        zspecs, st, loss_fn, batch, fold_word(kw, r, axis_index(group)), cfg,
        opt, impl=impl)
    if transport.packed_wire:
        agg = {p: transport.aggregate_collective_packed(upload[p], spec.n,
                                                        group)
               for p, spec in zspecs.specs.items()}
    else:
        agg = {p: transport.aggregate_collective(upload[p], group)
               for p in zspecs.specs}

    rep = round_wire_report(zspecs, cfg.aggregate, k, mode=cfg.mode,
                            downlink=cfg.downlink)
    metrics = {"loss": pmean(loss, group),
               **{name: rep[name] for name in WIRE_METRIC_KEYS},
               **_full_participation_metrics(k)}
    new_state = {"scores": _encode_scores(zspecs, cfg, agg, kw, r),
                 "dense": {p: pmean(d, group) for p, d in dense.items()}}
    return new_state, metrics
