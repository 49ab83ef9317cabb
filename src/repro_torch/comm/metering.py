"""Exact wire accounting: bytes on the network per federated round.

The JAX package's ``comm/metering.py``: ``round_wire_report``,
``wire_table`` and ``downlink_table``.  Analytic: a function of the spec
set, the uplink transport and the downlink codec.  Per round, per
client:

  uplink    = the transport's mask bytes per zampled tensor (uint32
              lane padding included) + f32 bytes of the dense leaves;
  downlink  = the codec's score bytes per zampled tensor (b bits a
              coordinate, or a packed codec's realized lanes, 32 bits
              each) + the same dense leaves.
"""

from __future__ import annotations

from typing import Dict, List

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
