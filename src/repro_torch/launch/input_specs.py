"""Model inputs per (arch, input-shape), the JAX package's
``launch/input_specs.py``: shapes and dtypes, and real random batches.

Modality stubs: VLM archs get precomputed patch/text embeddings (B, S,
d_model); audio/enc-dec archs get encoder frame embeddings (B, S/4,
d_model) — a 4x conv-codec downsampling stand-in — plus decoder token
ids.  ``make_batch`` draws from ``RandomState(seed)`` in the JAX
package's order (the specs' insertion order), so both packages give the
same arrays by bits: int32 token ids, embeddings rounded from the
float64 draw to float32 and then, for a bf16 config, to bf16 by
round-to-nearest-even.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..configs.registry import InputShape

ENC_DOWNSAMPLE = 4


class TensorSpec(NamedTuple):
    """Shape and dtype of one model input (JAX's ShapeDtypeStruct)."""

    shape: tuple
    dtype: torch.dtype


def _embed_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def input_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, TensorSpec]:
    """The spec of every model input of this (arch, shape)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = _embed_dtype(cfg)
    if shape.kind == "decode":
        return {"tokens": TensorSpec((B, 1), i32)}
    specs: Dict[str, TensorSpec] = {}
    if cfg.family in ("encdec", "audio"):
        specs["enc_embeds"] = TensorSpec(
            (B, S // ENC_DOWNSAMPLE, cfg.d_model), dt)
        specs["tokens"] = TensorSpec((B, S), i32)
    elif cfg.embed_stub:  # vlm
        specs["embeds"] = TensorSpec((B, S, cfg.d_model), dt)
    else:
        specs["tokens"] = TensorSpec((B, S), i32)
    if shape.kind == "train":
        specs["labels"] = TensorSpec((B, S), i32)
    return specs


def make_batch(cfg: ArchConfig, shape: InputShape, seed: int = 0, *,
               device="cpu") -> Dict[str, torch.Tensor]:
    """A random batch with the structure of ``input_specs``, on
    ``device``."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        if not spec.dtype.is_floating_point:
            a = torch.from_numpy(rng.randint(0, cfg.vocab, spec.shape).astype(
                np.int32))
        else:
            a = torch.from_numpy(rng.randn(*spec.shape).astype(np.float32))
        out[name] = a.to(spec.dtype).to(device)
    return out
