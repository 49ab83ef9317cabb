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
carried state.

Downlink schedules (``FederatedConfig.downlink_schedule``): ``cosine``
anneals one width from ``schedule_b_min`` up to the codec's over
``schedule_rounds`` rounds; ``frontier`` carries a per-tensor width
vector ``state["downlink_b"]`` and moves each width by 2 from the
measured flip fraction of the round's aggregate.  The broadcast is
quantized at those widths and widened into the codec's words
(``encode_at``), so the carry and every reader of it stay as they are;
the metrics count the b bits a coordinate sent.  ``constant`` is the
plain path.

Partial participation (``client_ids``, ``weights``, ``faults``; the
``repro_torch.fault`` package): the server's update becomes
``sum_k w_k b_k z_k / sum_k w_k b_k``, w_k a client's sample count and
b_k whether its upload arrived and passed validation.  The weights
enter the integer vote counts exactly and the mean is taken in
reciprocal form, ``counts * (1 / wsum)``; the dense leaves and the loss
are ascending sums over the clients as ``mean0``'s, so at weight 1 and
no fault the round is the plain round's bit for bit.  A round with
fewer than ``min_clients`` survivors is skipped: the state comes back
unchanged and ``round_skipped`` is 1.  The counters and the realized
bytes (``comm.metering.realized_wire_metrics``) stay tensors, so a
round never waits on the device.

Streaming (``0 < stream_chunk < K``): the same round over chunks of
``stream_chunk`` clients, a Python loop that trains a chunk (kernels 8,
6 and 10 at K = the chunk) and folds its uploads into the (n,) vote
counts, so no (K, lanes) slab is built.  The last chunk is shorter
when the chunk does not divide K: nothing is padded.  The counts are
integers and the ascending sums of the dense leaves and the loss go on
across chunks, so a streamed round is the slab round bit for bit
wherever each client trains to the same bits in its chunk as in the
slab (the model's batched products need not round alike over another
number of clients on the card).  A chunk above
``kernels.qz_reconstruct.MAX_K`` raises on a CUDA tensor, as the kernels
do.

The sharded round's participation form (``client_id``, ``weight``,
``faults`` on each rank) all-reduces the weighted sums and the
counters.

The model axis (``row_sharding``, a rank's model ``AxisGroup`` on a
grid of data x model ranks, ``launch.mesh``): a client's leaves built
with the sharding-major layout are split over its model group, each
rank holding its slice of their scores (``core.zampling.shard_slice``)
and drawing, reconstructing and transposing only its own windows; the
dense leaves are replicated over the model group.  The uplink's
collective, the dense mean and the loss's mean run over the data group
(``group``) on each rank's slice, the downlink is re-encoded a slice at
a time at global coordinates, and the metering counts the whole tensor
once (the figures come from the specs).  Faults act on the slices with
whole-upload checksums (a model all-reduce).  The frontier schedule,
which needs a whole tensor's flip fraction, is refused on a model axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..comm.downlink import get_codec
from ..comm.metering import (realized_wire_metrics, round_wire_report,
                             scheduled_wire_metrics)
from ..comm.protocol import mean0, pmean, resolve_transport
from ..comm.shardmap import axis_index, axis_size
from ..device import as_tensor, resolve_device
from ..fault.plan import (CORRUPT, DROP, DUPLICATE, STRAGGLER,
                          corrupt_uploads, draw_faults)
from ..fault.validate import upload_counts, validate_uploads
from ..optim import Optimizer, sgd
from .sampling import (as_word, as_words, clip_probs, fold_word,
                       quant_threshold_u24_dyn)
from .zampling import (MASK_MODES, MaskProgram, ZamplingSpecs,
                       infer_downlink, shard_slice, state_to,
                       validate_carried)

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
PARTICIPATION_METRIC_KEYS = (
    "cohort_size",
    "num_participating",
    "num_dropped",
    "num_stragglers",
    "num_corrupt",
    "num_duplicates",
    "weight_sum",
    "round_skipped",
)
ROUND_METRIC_KEYS = ("loss",) + WIRE_METRIC_KEYS + PARTICIPATION_METRIC_KEYS
# the counters a participation round sums over its clients (uplink_units
# goes into the realized bytes, the rest are metrics)
_COUNTER_KEYS = ("num_participating", "num_dropped", "num_stragglers",
                 "num_corrupt", "num_duplicates", "uplink_units")


@dataclass(frozen=True)
class FederatedConfig:
    """The JAX package's fields, defaults and checks."""

    num_clients: int = 10
    local_steps: int = 1  # "epochs" per round in the paper (up to 100)
    local_lr: float = 0.1
    mode: str = "sample"
    aggregate: str = "mean"  # a comm.protocol transport name
    mask_path: str = "fused"
    downlink: str = "f32"  # a comm.downlink codec name
    min_clients: int = 1  # fewer survivors than this: the round is skipped
    stream_chunk: int = 0  # 0 < C < K: fold the uploads C clients at a time
    downlink_schedule: str = "constant"
    schedule_b_min: int = 2  # the schedules' floor width
    schedule_rounds: int = 0  # cosine's anneal horizon, in rounds
    frontier_threshold: float = 0.02

    def __post_init__(self):
        if self.min_clients < 1:
            raise ValueError(f"min_clients must be >= 1, got "
                             f"{self.min_clients}")
        if self.stream_chunk < 0:
            raise ValueError(f"stream_chunk must be >= 0 (0 = slab path), "
                             f"got {self.stream_chunk}")
        resolve_transport(self.aggregate)
        codec = get_codec(self.downlink)
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
        if self.downlink_schedule == "constant":
            return
        if not codec.quantized:
            raise ValueError(
                f"downlink_schedule={self.downlink_schedule!r} needs a "
                f"quantized downlink codec to rate-control; "
                f"{self.downlink!r} is not quantized")
        if not 1 <= self.schedule_b_min <= codec.bits:
            raise ValueError(
                f"schedule_b_min must be in [1, {codec.bits}] for downlink "
                f"codec {self.downlink!r}, got {self.schedule_b_min}")
        if self.downlink_schedule == "cosine" and self.schedule_rounds < 1:
            raise ValueError(
                "downlink_schedule='cosine' needs schedule_rounds >= 1 (the "
                f"anneal horizon), got {self.schedule_rounds}")
        if (self.downlink_schedule == "frontier"
                and self.frontier_threshold <= 0):
            raise ValueError(f"frontier_threshold must be > 0, got "
                             f"{self.frontier_threshold}")


def mask_program(zspecs: ZamplingSpecs, cfg: FederatedConfig,
                 impl: Optional[str] = None) -> MaskProgram:
    """The round's mask lifecycle; ``packed`` is the transport's."""
    transport = resolve_transport(cfg.aggregate, cfg.mode)
    return MaskProgram(zspecs, mode=cfg.mode,
                       fused=cfg.mask_path == "fused",
                       packed=transport.packed_wire, downlink=cfg.downlink,
                       impl=impl)


def _with_schedule_state(zspecs: ZamplingSpecs, cfg: FederatedConfig,
                         state, device) -> Dict[str, Any]:
    """A frontier state carries its per-tensor widths, starting at
    ``schedule_b_min``; other schedules carry none."""
    if cfg.downlink_schedule != "frontier" or "downlink_b" in state:
        return state
    return {**state, "downlink_b": torch.full(
        (len(zspecs.specs),), cfg.schedule_b_min, dtype=torch.int64,
        device=device)}


def encode_state(zspecs: ZamplingSpecs, cfg: FederatedConfig, state,
                 word=0, *, device="cuda") -> Dict[str, Any]:
    """An f32 score state (numpy or tensors) in ``cfg.downlink``'s wire
    words on ``device`` — what the rounds carry — with the frontier
    schedule's widths ``downlink_b``.  ``word`` keys the dither.  A
    state already carrying the codec (by dtype and, for a packed codec,
    lane count) passes through; one carrying another codec raises."""
    dev = resolve_device(device)
    st = state_to(zspecs, state, dev)
    codec = get_codec(cfg.downlink)
    try:
        validate_carried(zspecs, st["scores"], codec.name)
        return _with_schedule_state(zspecs, cfg, st, dev)
    except ValueError:
        pass
    carried = infer_downlink(st["scores"])
    if carried != "f32":
        raise ValueError(f"state is already encoded with downlink codec "
                         f"{carried!r}; decode_state it first before "
                         f"re-encoding as {codec.name!r}")
    w = as_word(word)
    return _with_schedule_state(zspecs, cfg, {
        **st, "scores": {p: codec.encode(spec, st["scores"][p], w)
                         for p, spec in zspecs.specs.items()}}, dev)


def decode_state(zspecs: ZamplingSpecs, cfg: FederatedConfig, state, *,
                 device="cuda") -> Dict[str, Any]:
    """Wire-encoded round carry -> f32 score state (lossy inverse of
    ``encode_state``)."""
    st = state_to(zspecs, state, resolve_device(device))
    return {**st,
            "scores": mask_program(zspecs, cfg).decode_scores(st["scores"])}


def local_update(zspecs: ZamplingSpecs, state: Dict[str, Any],
                 loss_fn: LossFn, batches: Dict[str, torch.Tensor], words,
                 cfg: FederatedConfig, opt: Optional[Optimizer] = None, *,
                 constraints=None, row_sharding=None,
                 impl: Optional[str] = None):
    """K clients' local round at once, or one client's: E score steps,
    then the upload.

    ``state``: the encoded broadcast (tensors on one device);
    ``words``: the K clients' draw words ``kw`` (ints, or a (K,) int64
    tensor on the state's device) with ``batches`` {name: (K, E, B,
    ...)}, or one client's word with {name: (E, B, ...)}.  Returns
    (uploads {path: (K, L) lanes, or (K, n) f32 masks on an f32
    transport}, dense {path: (K, ...)}, (K,) mean losses over the E
    steps), without the K axis for one client: the JAX package's
    ``local_update`` as the sharded round runs it, on the K=1 kernels.
    On a model axis (``row_sharding``) the state, the gradients and the
    uploads of a sharded leaf are this rank's slices; ``constraints``
    as ``core.zampling.weights_from_masks``."""
    opt = opt or sgd(cfg.local_lr)
    program = mask_program(zspecs, cfg, impl)
    dev = next(iter(state["scores"].values())).device
    steps = cfg.local_steps
    one = not isinstance(words, torch.Tensor) and np.ndim(words) == 0
    if isinstance(words, torch.Tensor):
        # (E+1, K) step words hashed on the device: no host round trip
        kw = words.to(device=dev, dtype=torch.int64)
        step_words = fold_word(kw[None, :], torch.arange(
            steps + 1, dtype=torch.int64, device=dev)[:, None])
        k = kw.shape[0]
    else:
        kws = [words] if one else list(words)
        step_words = as_words([[fold_word(kw, e) for kw in kws]
                               for e in range(steps + 1)], dev)  # (E+1, K)
        k = len(kws)
    lead = (steps,) if one else (k, steps)
    for name, v in batches.items():
        if tuple(v.shape[:len(lead)]) != lead:
            raise ValueError(f"batch {name!r} has leading shape "
                             f"{tuple(v.shape[:len(lead)])}, expected "
                             f"{lead}")
    scores0 = program.decode_scores(state["scores"], row_sharding)
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
            {p: leaves[p] for p in zspecs.dense_paths}, step_words[e],
            constraints, row_sharding)
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
    up_word = fold_word(words, steps) if one else step_words[steps]
    uploads = program.upload({p: trainable[p] for p in zspecs.specs},
                             up_word, row_sharding)
    dense = {p: trainable[p] for p in zspecs.dense_paths}
    return uploads, dense, torch.stack(losses).mean(0)


# ---------------------------------------------------------------------------
# Downlink schedules
# ---------------------------------------------------------------------------

def cosine_width(cfg: FederatedConfig, round_index: int) -> int:
    """The cosine schedule's width in round ``round_index``: ``b_min +
    span (1 - cos(pi t / H)) / 2``, rounded half to even, in float32 on
    the host as XLA runs the JAX package's under ``jit``: it folds the
    constants (``t * (pi * (1 / H))``, ``(1 - cos) * (span / 2)``) and
    fuses the last multiply and add into one rounding.  A width lands on
    x.5 (t = H/2 with an odd span), where one ulp decides it."""
    f32 = np.float32
    bits = get_codec(cfg.downlink).bits
    horizon = f32(cfg.schedule_rounds)
    t = np.minimum(f32(round_index), horizon)
    c = f32(1.0) - np.cos(t * (f32(np.pi) * (f32(1.0) / horizon)))
    half_span = f32(bits - cfg.schedule_b_min) * f32(0.5)
    # a fused multiply-add: the float64 product and sum are exact
    b = f32(np.float64(c) * np.float64(half_span)
            + np.float64(cfg.schedule_b_min))
    return int(np.clip(np.round(b), cfg.schedule_b_min, bits))


def _round_b_vec(zspecs: ZamplingSpecs, cfg: FederatedConfig, state,
                 round_index: int, device) -> Optional[torch.Tensor]:
    """The round's per-tensor downlink widths (int64 on ``device``), or
    None on the constant schedule: cosine's one width for every tensor,
    or frontier's carried ``state["downlink_b"]`` (the floor when the
    state carries none)."""
    if cfg.downlink_schedule == "constant":
        return None
    if cfg.downlink_schedule == "frontier" and "downlink_b" in state:
        return state["downlink_b"].to(device=device, dtype=torch.int64)
    b = (cfg.schedule_b_min if cfg.downlink_schedule == "frontier"
         else cosine_width(cfg, round_index))
    return torch.full((len(zspecs.specs),), b, dtype=torch.int64,
                      device=device)


def _flip_fraction(p: torch.Tensor, b, b_hi) -> torch.Tensor:
    """The expected share of draws that flip between widths ``b`` and
    ``b_hi`` at probabilities ``p``: a draw at width b fires iff ``(u >>
    8) < T_b``, so a coordinate flips with probability ``|T_b - T_hi| *
    2^-24``.  An f32 mean over n (XLA sums in its own order: allclose to
    the JAX package's, not bitwise)."""
    def thr(bits):
        bf = ((1 << bits) - 1).to(torch.float32)
        q = torch.floor(p * bf + 0.5)
        q = torch.minimum(torch.maximum(q, q.new_zeros(())), bf)
        return quant_threshold_u24_dyn(q.to(torch.int64), bits)

    diff = (thr(b) - thr(b_hi)).abs()
    return diff.to(torch.float32).mean() * float(np.float32(2.0 ** -24))


def _frontier_next_b(zspecs: ZamplingSpecs, cfg: FederatedConfig, agg,
                     b_vec: torch.Tensor) -> torch.Tensor:
    """Next round's frontier widths from the round's f32 aggregate (before
    it is quantized): tensor i's width rises by 2 where the flip fraction
    between b and b + 2 exceeds ``frontier_threshold``, falls by 2 where
    it is under a quarter of it, within [schedule_b_min, codec bits]."""
    b_max = get_codec(cfg.downlink).bits
    up_at = float(np.float32(cfg.frontier_threshold))
    down_at = float(np.float32(cfg.frontier_threshold / 4.0))
    nxt = []
    for i, path in enumerate(zspecs.specs):
        b = b_vec[i]
        p = clip_probs(agg[path].to(torch.float32))
        flip = _flip_fraction(p, b, torch.clamp(b + 2, max=b_max))
        nb = torch.where(flip > up_at, b + 2,
                         torch.where((flip < down_at) & (b > 2), b - 2, b))
        nxt.append(torch.clamp(nb, cfg.schedule_b_min, b_max))
    return torch.stack(nxt)


def _schedule_state_out(zspecs, cfg, agg, b_vec, skip=None):
    """The frontier state's next widths (kept on a skipped round); {} for
    the other schedules."""
    if cfg.downlink_schedule != "frontier":
        return {}
    nb = _frontier_next_b(zspecs, cfg, agg, b_vec)
    if skip is not None:
        nb = torch.where(skip, b_vec, nb)
    return {"downlink_b": nb}


def _wire_metrics(zspecs: ZamplingSpecs, cfg: FederatedConfig, k: int,
                  b_vec=None) -> Dict[str, Any]:
    """The round's exact byte counts at K clients; a scheduled round's
    downlink counts are the widths' realized bits (f32 tensors)."""
    rep = round_wire_report(zspecs, cfg.aggregate, k, mode=cfg.mode,
                            downlink=cfg.downlink)
    if b_vec is not None:
        rep = scheduled_wire_metrics(rep, zspecs, b_vec, k)
    return {name: rep[name] for name in WIRE_METRIC_KEYS}


def _encode_scores(zspecs, cfg, agg, word: int, round_index: int,
                   b_vec=None, row_sharding=None):
    """Re-encode p(t+1) as the next broadcast, dither keyed by
    ``fold_word(word, round_index)``; tensor i at width ``b_vec[i]``
    when the round is scheduled; a model rank's slices at their global
    coordinates."""
    codec = get_codec(cfg.downlink)
    if not codec.quantized:
        return agg
    w = fold_word(word, round_index)
    c0 = {p: shard_slice(spec, row_sharding)[0]
          for p, spec in zspecs.specs.items()}
    if b_vec is None:
        return {p: codec.encode(spec, agg[p], w, c0[p])
                for p, spec in zspecs.specs.items()}
    return {p: codec.encode_at(spec, agg[p], w, b_vec[i], c0[p])
            for i, (p, spec) in enumerate(zspecs.specs.items())}


def _full_participation_metrics(k: int) -> Dict[str, float]:
    return {"cohort_size": float(k), "num_participating": float(k),
            "num_dropped": 0.0, "num_stragglers": 0.0, "num_corrupt": 0.0,
            "num_duplicates": 0.0, "weight_sum": float(k),
            "round_skipped": 0.0}


# ---------------------------------------------------------------------------
# Partial participation and streaming
# ---------------------------------------------------------------------------

def _resolve_faults(zspecs, packed: bool, z_all, faults, round_index: int,
                    ids: torch.Tensor, row_sharding=None):
    """The per-upload fault pipeline of every driver, keyed by client id.
    Returns (the uploads as received, fault codes, arrived, arrived and
    valid).  On a model axis a sharded leaf's upload is this rank's
    slice: its checksums are summed over the model group, so every rank
    of a client judges the whole upload alike."""
    total = offsets = None
    if row_sharding is not None and row_sharding.size > 1:
        sharded = {p for p, spec in zspecs.specs.items()
                   if spec.shard_count > 1}

        def total(path, x):
            return _all_sum(x, row_sharding.group) if path in sharded else x

        offsets = {p: shard_slice(spec, row_sharding)[0] // (32 if packed
                                                             else 1)
                   for p, spec in zspecs.specs.items()}
    declared = upload_counts(z_all, zspecs, packed)
    if total is not None:
        declared = {p: total(p, c) for p, c in declared.items()}
    if faults is not None:
        codes = draw_faults(faults, round_index, ids)
        z_wire = corrupt_uploads(faults, z_all, declared, codes == CORRUPT,
                                 round_index, ids, zspecs, packed, offsets,
                                 total)
    else:
        codes = torch.zeros_like(ids)
        z_wire = z_all
    arrived = (codes != DROP) & (codes != STRAGGLER)
    # the check reads the received payload, not the injector's flag
    valid = validate_uploads(z_wire, declared, zspecs, packed, total)
    return z_wire, codes, arrived, arrived & valid


def _fault_counts(codes, arrived, participating) -> Dict[str, torch.Tensor]:
    """The participation counters (f32) of the clients on the leading
    axis (or of one client)."""
    def cnt(mask):
        return mask.to(torch.float32).sum()

    dup = cnt(codes == DUPLICATE)
    return {"num_participating": cnt(participating),
            "num_dropped": cnt(codes == DROP),
            "num_stragglers": cnt(codes == STRAGGLER),
            "num_corrupt": cnt(arrived & ~participating),
            "num_duplicates": dup,
            # arrivals spend uplink bytes even when validation rejects
            # them; a duplicate arrives twice
            "uplink_units": cnt(arrived) + dup}


def _ascending_fold(acc, x: torch.Tensor, w: torch.Tensor):
    """``acc + x[0] w[0] + x[1] w[1] + ...`` in f32, in ascending client
    order, starting from the first product when ``acc`` is None:
    ``mean0``'s sum at weight 1, and the same sum across chunks."""
    for j in range(x.shape[0]):
        t = x[j].to(torch.float32) * w[j]
        acc = t if acc is None else acc + t
    return acc


def _keep_if(skip: torch.Tensor, old: torch.Tensor,
             new: torch.Tensor) -> torch.Tensor:
    """``old`` where ``skip`` (0-d bool), else ``new``; uint32 and uint16
    through their signed views."""
    view = {torch.uint32: torch.int32, torch.uint16: torch.int16}.get(
        new.dtype)
    if view is None:
        return torch.where(skip, old, new)
    return torch.where(skip, old.view(view), new.view(view)).view(new.dtype)


def _recip(x: torch.Tensor) -> torch.Tensor:
    """f32 ``1 / x`` with a zero guard, the round's reciprocal form."""
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.ones_like(safe) / safe


def _cohort(client_ids, k: int, dev):
    """(ids as an int64 tensor on ``dev``, the ids the draw words hash:
    Python ints, or that tensor when the ids already live on ``dev``)."""
    if client_ids is None:
        return torch.arange(k, dtype=torch.int64, device=dev), list(range(k))
    if (isinstance(client_ids, torch.Tensor)
            and client_ids.device.type == dev.type):
        ids = client_ids.to(device=dev, dtype=torch.int64)
        return ids, ids
    host = as_words(client_ids, "cpu")
    return host.to(dev), [int(i) for i in host]


def _client_words(kw: int, r: int, src):
    """Clients' draw words ``fold_word(kw, r, id)``: ints or a tensor."""
    if isinstance(src, torch.Tensor):
        return fold_word(kw, r, src)
    return [fold_word(kw, r, i) for i in src]


def _participation_round(zspecs, st, loss_fn, batches, kw: int, r: int,
                         cfg: FederatedConfig, opt, *, ids, src,
                         w: torch.Tensor, faults, k: int, chunk: int,
                         constraints=None, row_sharding=None, impl=None):
    """The weighted round over K clients, ``chunk`` at a time (K: the
    slab round), folding each chunk's validated uploads into the vote
    counts.  Returns (state', metrics)."""
    transport = resolve_transport(cfg.aggregate, cfg.mode)
    packed = transport.packed_wire
    dev = ids.device
    n_of = {p: shard_slice(spec, row_sharding)[1]
            for p, spec in zspecs.specs.items()}
    votes = {p: transport.stream_init(n_of[p], dev) for p in zspecs.specs}
    dense, loss = {p: None for p in zspecs.dense_paths}, None
    wsum = torch.zeros((), dtype=torch.int64, device=dev)
    counters = {c: torch.zeros((), device=dev) for c in _COUNTER_KEYS}
    for c0 in range(0, k, chunk):
        sl = slice(c0, min(c0 + chunk, k))
        uploads, dense_c, losses = local_update(
            zspecs, st, loss_fn, {n: v[sl] for n, v in batches.items()},
            _client_words(kw, r, src[sl]), cfg, opt, constraints=constraints,
            row_sharding=row_sharding, impl=impl)
        z_wire, codes, arrived, part = _resolve_faults(
            zspecs, packed, uploads, faults, r, ids[sl], row_sharding)
        w_eff = w[sl] * part.to(torch.int64)
        for p in zspecs.specs:
            votes[p] = (transport.fold_stacked_packed_weighted(
                votes[p], z_wire[p], n_of[p], w_eff) if packed else
                transport.fold_stacked_weighted(votes[p], z_wire[p], w_eff))
        w_f = w_eff.to(torch.float32)
        dense = {p: _ascending_fold(dense[p], dense_c[p], w_f)
                 for p in zspecs.dense_paths}
        loss = _ascending_fold(loss, losses, part.to(torch.float32))
        wsum = wsum + w_eff.sum()
        counts = _fault_counts(codes, arrived, part)
        counters = {c: counters[c] + counts[c] for c in _COUNTER_KEYS}

    wsum_f = wsum.to(torch.float32)
    recip = _recip(wsum_f)
    agg = {p: v.to(torch.float32) * recip for p, v in votes.items()}
    b_vec = _round_b_vec(zspecs, cfg, st, r, dev)
    new_enc = _encode_scores(zspecs, cfg, agg, kw, r, b_vec, row_sharding)
    skip = counters["num_participating"] < cfg.min_clients
    new_state = {
        "scores": {p: _keep_if(skip, st["scores"][p], new_enc[p])
                   for p in zspecs.specs},
        "dense": {p: _keep_if(skip, st["dense"][p],
                              (dense[p] * recip).to(st["dense"][p].dtype))
                  for p in zspecs.dense_paths},
        **_schedule_state_out(zspecs, cfg, agg, b_vec, skip)}
    uplink_units = counters.pop("uplink_units")
    metrics = {"loss": loss * _recip(counters["num_participating"]),
               **realized_wire_metrics(_wire_metrics(zspecs, cfg, k, b_vec),
                                       uplink_units, k),
               "cohort_size": float(k), **counters, "weight_sum": wsum_f,
               "round_skipped": skip.to(torch.float32)}
    return new_state, metrics


def federated_round(zspecs: ZamplingSpecs, state: Dict[str, Any],
                    loss_fn: LossFn, client_batches, key,
                    cfg: FederatedConfig, opt: Optional[Optimizer] = None, *,
                    round_index=0, client_ids=None, weights=None,
                    faults=None, constraints=None, row_sharding=None,
                    impl: Optional[str] = None, device="cuda"):
    """One round over the K clients stacked on the batches' leading axis.
    ``key`` is the round's uint32 draw word; client k trains at
    ``fold_word(key, round_index, client_ids[k])``.

    ``client_ids`` ((K,) ints, or an int64 tensor on ``device``),
    ``weights`` ((K,) sample counts) and ``faults`` (a ``FaultPlan``)
    switch on the weighted partial-participation round; with all three
    None the plain round runs.  ``0 < cfg.stream_chunk < K`` runs the
    round in chunks.  Returns (state', metrics); state' carries
    ``cfg.downlink``'s words (and a frontier schedule's widths).  On a
    model group (``row_sharding``, this rank's model AxisGroup) every
    rank runs the K clients on its slices of the sharded leaves and
    returns its slices of state'."""
    _refuse_frontier(zspecs, cfg, row_sharding)
    dev = resolve_device(device)
    st = state_to(zspecs, state, dev)
    batches = {n: as_tensor(v, dev) for n, v in client_batches.items()}
    k = next(iter(batches.values())).shape[0]
    transport = resolve_transport(cfg.aggregate, cfg.mode)
    kw, r = as_word(key), as_word(round_index)
    streaming = 0 < cfg.stream_chunk < k
    if streaming or not (client_ids is None and weights is None
                         and faults is None):
        ids, src = _cohort(client_ids, k, dev)
        w = (torch.ones((k,), dtype=torch.int64, device=dev)
             if weights is None else as_words(weights, dev))
        return _participation_round(
            zspecs, st, loss_fn, batches, kw, r, cfg, opt, ids=ids, src=src,
            w=w, faults=faults, k=k,
            chunk=cfg.stream_chunk if streaming else k,
            constraints=constraints, row_sharding=row_sharding, impl=impl)
    words = [fold_word(kw, r, i) for i in range(k)]
    uploads, dense_all, losses = local_update(
        zspecs, st, loss_fn, batches, words, cfg, opt,
        constraints=constraints, row_sharding=row_sharding, impl=impl)
    if transport.packed_wire:
        agg = {p: transport.aggregate_stacked_packed(
            uploads[p], shard_slice(spec, row_sharding)[1])
            for p, spec in zspecs.specs.items()}
    else:
        agg = {p: transport.aggregate_stacked(uploads[p])
               for p in zspecs.specs}
    b_vec = _round_b_vec(zspecs, cfg, st, r, dev)
    metrics = {"loss": mean0(losses), **_wire_metrics(zspecs, cfg, k, b_vec),
               **_full_participation_metrics(k)}
    new_state = {"scores": _encode_scores(zspecs, cfg, agg, kw, r, b_vec,
                                          row_sharding),
                 "dense": {p: mean0(d) for p, d in dense_all.items()},
                 **_schedule_state_out(zspecs, cfg, agg, b_vec)}
    return new_state, metrics


def _refuse_frontier(zspecs, cfg: FederatedConfig, row_sharding) -> None:
    if (row_sharding is not None and cfg.downlink_schedule == "frontier"
            and any(s.shard_count > 1 for s in zspecs.specs.values())):
        raise ValueError(
            "downlink_schedule='frontier' needs each tensor's whole flip "
            "fraction; it is not run on a model axis (ROADMAP, queue 1, "
            "item 9 Part B)")


def _all_sum(x: torch.Tensor, group) -> torch.Tensor:
    s = x.clone()
    dist.all_reduce(s, group=group)
    return s


def sharded_client_update(zspecs: ZamplingSpecs, state: Dict[str, Any],
                          loss_fn: LossFn, batches, key,
                          cfg: FederatedConfig,
                          opt: Optional[Optimizer] = None, *, group=None,
                          constraints=None, row_sharding=None,
                          round_index=0, client_id=None, weight=None,
                          faults=None, impl: Optional[str] = None,
                          device="cuda"):
    """One round on this rank's client: the JAX package's
    ``sharded_client_update`` body, a client per rank of ``group`` (the
    default group when None).

    ``batches``: this client's {name: (E, B, ...)}; ``key``: the round's
    uint32 word, the same on every rank.  Rank k trains at
    ``fold_word(key, round_index, k)``, ``federated_round``'s client k.
    The uploads meet in the transport's collective; every rank re-encodes
    the mean at the replicated dither word and averages the dense leaves
    and the loss by ``pmean``, so every rank returns the same (state',
    metrics), K being the group's size.

    ``client_id`` (this rank's global id, an int), ``weight`` (its
    sample count) and ``faults`` switch on the weighted round: fault
    draws and validation key on the client id, and the weighted sums and
    the counters meet in all-reduces, so a scenario gives the stacked
    round's counters and words.

    On a grid ``group`` is this rank's data group and ``row_sharding``
    its model ``AxisGroup``: ``state`` holds the rank's slices of the
    sharded leaves (``convert.to_model_rank``), ``batches`` its client's
    (the same on every rank of the model group), and the state it
    returns holds the slices of the next broadcast.  ``constraints`` as
    ``core.zampling.weights_from_masks``."""
    _refuse_frontier(zspecs, cfg, row_sharding)
    dev = resolve_device(device)
    st = state_to(zspecs, state, dev)
    batch = {n: as_tensor(v, dev) for n, v in batches.items()}
    transport = resolve_transport(cfg.aggregate, cfg.mode)
    packed = transport.packed_wire
    kw, r = as_word(key), as_word(round_index)
    k = axis_size(group)
    my_id = axis_index(group) if client_id is None else as_word(client_id)
    upload, dense, loss = local_update(
        zspecs, st, loss_fn, batch, fold_word(kw, r, my_id), cfg, opt,
        constraints=constraints, row_sharding=row_sharding, impl=impl)
    b_vec = _round_b_vec(zspecs, cfg, st, r, dev)
    n_of = {p: shard_slice(spec, row_sharding)[1]
            for p, spec in zspecs.specs.items()}

    if client_id is None and weight is None and faults is None:
        if packed:
            agg = {p: transport.aggregate_collective_packed(upload[p],
                                                            n_of[p], group)
                   for p in zspecs.specs}
        else:
            agg = {p: transport.aggregate_collective(upload[p], group)
                   for p in zspecs.specs}
        metrics = {"loss": pmean(loss, group),
                   **_wire_metrics(zspecs, cfg, k, b_vec),
                   **_full_participation_metrics(k)}
        return {"scores": _encode_scores(zspecs, cfg, agg, kw, r, b_vec,
                                         row_sharding),
                "dense": {p: pmean(d, group) for p, d in dense.items()},
                **_schedule_state_out(zspecs, cfg, agg, b_vec)}, metrics

    ids = torch.tensor(my_id, dtype=torch.int64, device=dev)
    z_wire, code, arrived, part = _resolve_faults(zspecs, packed, upload,
                                                  faults, r, ids,
                                                  row_sharding)
    w = torch.tensor(1 if weight is None else as_word(weight),
                     dtype=torch.int64, device=dev)
    w_eff = w * part.to(torch.int64)
    counts = _fault_counts(code, arrived, part)
    # the counters and the weight sum in one all-reduce of exact integers
    summed = _all_sum(torch.stack(
        [w_eff] + [counts[c].to(torch.int64) for c in _COUNTER_KEYS]), group)
    wsum_f = summed[0].to(torch.float32)
    counters = {c: summed[i + 1].to(torch.float32)
                for i, c in enumerate(_COUNTER_KEYS)}
    recip = _recip(wsum_f)
    if packed:
        agg = {p: transport.aggregate_collective_packed_weighted(
            z_wire[p], n_of[p], w_eff, group).to(torch.float32) * recip
            for p in zspecs.specs}
    else:
        agg = {p: transport.aggregate_collective_weighted(
            z_wire[p], w_eff, group) * recip for p in zspecs.specs}
    new_enc = _encode_scores(zspecs, cfg, agg, kw, r, b_vec, row_sharding)
    w_f = w_eff.to(torch.float32)
    skip = counters["num_participating"] < cfg.min_clients
    new_state = {
        "scores": {p: _keep_if(skip, st["scores"][p], new_enc[p])
                   for p in zspecs.specs},
        "dense": {p: _keep_if(skip, st["dense"][p], (_all_sum(
            d.to(torch.float32) * w_f, group) * recip).to(d.dtype))
            for p, d in dense.items()},
        **_schedule_state_out(zspecs, cfg, agg, b_vec, skip)}
    uplink_units = counters.pop("uplink_units")
    loss_sum = _all_sum(loss.to(torch.float32) * part.to(torch.float32),
                        group)
    metrics = {"loss": loss_sum * _recip(counters["num_participating"]),
               **realized_wire_metrics(_wire_metrics(zspecs, cfg, k, b_vec),
                                       uplink_units, k),
               "cohort_size": float(k), **counters, "weight_sum": wsum_f,
               "round_skipped": skip.to(torch.float32)}
    return new_state, metrics
