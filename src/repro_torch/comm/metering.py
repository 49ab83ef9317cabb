"""Exact wire accounting: bytes on the network per federated round.

The JAX package's ``comm/metering.py``: ``round_wire_report``,
``wire_table`` and ``downlink_table``; the scheduled and realized
counts of the downlink schedules and of partial participation; the
upload memory of the slab and streaming rounds; and a serving node's
delta wire and resident bytes.  Analytic: a function
of the spec set, the uplink transport and the downlink codec.  Per
round, per client:

  uplink    = the transport's mask bytes per zampled tensor (uint32
              lane padding included) + f32 bytes of the dense leaves;
  downlink  = the codec's score bytes per zampled tensor (b bits a
              coordinate, or a packed codec's realized lanes, 32 bits
              each) + the same dense leaves.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .downlink import DownlinkCodec, codec_names, get_codec
from .protocol import Transport, resolve_transport, transport_names

_F32_BYTES = 4


def mask_uplink_bytes(transport: Transport, n: int) -> int:
    """Exact wire bytes of one client's n-coordinate mask upload."""
    return -(-transport.uplink_bits_per_client(n) // 8)


def score_downlink_bytes(codec: DownlinkCodec, n: int) -> int:
    """Exact wire bytes of the n-coordinate score broadcast to one
    client."""
    return -(-codec.downlink_bits_per_client(n) // 8)


def scheduled_downlink_bits(n: int, bits):
    """Realized downlink bits of one n-coordinate tensor sent at width
    ``bits``: b-bit words in uint32 lanes, ``32 * ceil(n / floor(32/b))``,
    the lanes' padding included.  An int for an int width, an int64
    tensor for a tensor width."""
    if isinstance(bits, int):
        wpl = 32 // bits
        return 32 * ((n + wpl - 1) // wpl)
    wpl = 32 // bits.to(torch.int64)
    return 32 * ((n + wpl - 1) // wpl)


def scheduled_wire_metrics(report, zspecs, b_vec: torch.Tensor,
                           num_clients: int):
    """``report`` with its downlink counts replaced by a scheduled
    round's realized ones: tensor i at width ``b_vec[i]`` (ordered as
    ``zspecs.specs``), the dense leaves in f32.  The replaced values are
    f32 tensors on ``b_vec``'s device, computed as the JAX package's
    traced round computes them."""
    bits = sum(scheduled_downlink_bits(spec.n, b_vec[i])
               for i, spec in enumerate(zspecs.specs.values()))
    dense_bytes = _F32_BYTES * zspecs.dense_total
    down = torch.ceil(bits.to(torch.float32) / 8.0) + float(
        np.float32(dense_bytes))
    down_f32 = float(np.float32(_F32_BYTES * zspecs.n_total + dense_bytes))
    return {**report,
            "downlink_bytes_per_client": down,
            "downlink_bytes_round": down * float(np.float32(num_clients)),
            "downlink_vs_f32": down / down_f32}


def round_wire_report(zspecs, aggregate: str, num_clients: int,
                      mode: str = "sample",
                      downlink: str = "f32") -> Dict[str, float]:
    """Exact per-round byte counts for one (transport, codec) pair."""
    t = resolve_transport(aggregate, mode)
    codec = get_codec(downlink)
    mask_up = sum(mask_uplink_bytes(t, s.n) for s in zspecs.specs.values())
    dense = _F32_BYTES * zspecs.dense_total
    up_client = mask_up + dense
    down_client = sum(score_downlink_bytes(codec, s.n)
                      for s in zspecs.specs.values()) + dense
    down_f32 = _F32_BYTES * zspecs.n_total + dense
    return {
        "transport": t.name,
        "downlink": codec.name,
        "uplink_bytes_per_client": float(up_client),
        "uplink_bytes_round": float(up_client * num_clients),
        "downlink_bytes_per_client": float(down_client),
        "downlink_bytes_round": float(down_client * num_clients),
        "downlink_vs_f32": float(down_client) / float(down_f32),
        "naive_uplink_bytes_per_client": float(
            _F32_BYTES * zspecs.m_total + dense),
    }


def upload_slab_bytes(zspecs, aggregate: str, num_clients: int,
                      mode: str = "sample") -> float:
    """Device bytes of the (K, lanes) upload slab the one-shot round
    stacks before it reduces: K uploads of their wire bytes each."""
    t = resolve_transport(aggregate, mode)
    per = sum(mask_uplink_bytes(t, s.n) for s in zspecs.specs.values())
    return float(per * num_clients)


def streaming_peak_bytes(zspecs, aggregate: str, chunk: int,
                         mode: str = "sample") -> float:
    """Upload-side device bytes of the streaming round at its peak: one
    chunk's uploads and an (n,) vote-count accumulator a tensor, counted
    at 4 bytes a coordinate as the JAX package counts it; whatever K."""
    acc = sum(_F32_BYTES * s.n for s in zspecs.specs.values())
    return upload_slab_bytes(zspecs, aggregate, chunk, mode) + acc


def delta_wire_bytes(total_words: int, changed_words: int,
                     word_bytes: int) -> int:
    """Exact wire bytes of a sparse word delta (``serve.delta``): the
    cheaper of a presence bitmap (ceil(total/8) + changed * word_bytes)
    and a coordinate list (4 + changed * (4 + word_bytes))."""
    if changed_words < 0 or changed_words > total_words:
        raise ValueError(f"changed_words={changed_words} outside "
                         f"[0, {total_words}]")
    bitmap = -(-total_words // 8) + changed_words * word_bytes
    coords = 4 + changed_words * (4 + word_bytes)
    return min(bitmap, coords)


def serve_tile_pool_bytes(zspecs, cache_budget: int, bm=None) -> int:
    """Allocated bytes of the hot-block tile pool at ``cache_budget``:
    ``min(budget // (4 bm), tiles)`` rows of 4 bm bytes, where tiles
    counts the canonical blocks of every zampled matmul leaf ('embed'
    streams through the row gather and owns none), as
    ``serve.cache.HotBlockCache`` allocates it."""
    from ..kernels import ops  # kernels sit above comm

    bm = bm or ops.SERVE_BM
    tiles = 0
    for path, spec in zspecs.specs.items():
        if path == "embed":
            continue
        groups, d_in, d_out = ops.serve_group_dims(spec)
        tiles += groups * ops.serve_block_grid(spec, bm, 0, d_in * d_out)[1]
    return min(int(cache_budget) // (4 * bm), tiles) * 4 * bm


def serve_resident_bytes(sstate, cache_budget: int = 0, *,
                         mode: str = "streaming",
                         kv_cache=None) -> Dict[str, float]:
    """Exact resident bytes of one serving node: the zampled state (the
    words and draw word, or in load mode the f32 leaves), the tile pool
    in cached mode, the KV cache's tensors (its positions are int64 in
    the port, int32 in the JAX package), and the dense leaves."""
    if mode not in ("load", "streaming", "cached"):
        raise ValueError(f"unknown serve mode {mode!r}")
    if mode == "load":
        zampled, pool = sstate.loaded_zampled_bytes(), 0
    else:
        zampled = sstate.resident_zampled_bytes()
        pool = (serve_tile_pool_bytes(sstate.zspecs, cache_budget)
                if mode == "cached" else 0)
    kv = 0 if kv_cache is None else sum(
        t.numel() * t.element_size() for t in kv_cache)
    dense = sstate.dense_bytes()
    return {"mode": mode, "zampled_bytes": float(zampled),
            "cache_bytes": float(pool), "kv_bytes": float(kv),
            "dense_bytes": float(dense),
            "total_bytes": float(zampled + pool + kv + dense)}


def realized_wire_metrics(report: Dict, uplink_units,
                          cohort_size: int) -> Dict:
    """A partial-participation round's realized byte counts.

    ``uplink_units``: the uploads that crossed the uplink (arrivals,
    corrupt ones included, plus a second copy a duplicate), an f32
    tensor or a number.  Dropped and late clients send nothing; every
    sampled client receives the broadcast.  Per-client figures stay the
    protocol's."""
    return {
        "uplink_bytes_per_client": report["uplink_bytes_per_client"],
        "uplink_bytes_round":
            report["uplink_bytes_per_client"] * uplink_units,
        "downlink_bytes_per_client": report["downlink_bytes_per_client"],
        "downlink_bytes_round":
            report["downlink_bytes_per_client"] * float(cohort_size),
        "naive_uplink_bytes_per_client":
            report["naive_uplink_bytes_per_client"],
    }


def wire_table(zspecs, num_clients: int, downlink: str = "f32") -> List[Dict]:
    """One row per uplink transport at the given codec."""
    baseline = round_wire_report(zspecs, "mean_f32", num_clients)
    rows = []
    for name in transport_names(include_aliases=False):
        rep = round_wire_report(zspecs, name, num_clients,
                                downlink=downlink)
        rows.append({
            "bench": "wire_format", "strategy": name, "K": num_clients,
            "n_total": zspecs.n_total, "m_total": zspecs.m_total, **rep,
            "uplink_vs_f32": rep["uplink_bytes_per_client"]
            / baseline["uplink_bytes_per_client"],
            "uplink_vs_naive": rep["uplink_bytes_per_client"]
            / rep["naive_uplink_bytes_per_client"],
        })
    return rows


def downlink_table(zspecs, num_clients: int,
                   aggregate: str = "psum_u32") -> List[Dict]:
    """One row per registered downlink codec (aliases left out) at the
    given transport."""
    return [{"bench": "downlink_format", "codec": name, "K": num_clients,
             "n_total": zspecs.n_total, "m_total": zspecs.m_total,
             **round_wire_report(zspecs, aggregate, num_clients,
                                 downlink=name)}
            for name in codec_names(include_aliases=False)]
