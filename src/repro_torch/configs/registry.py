"""Architecture + input-shape registry (``--arch`` / ``--shape`` lookup),
the JAX package's ``configs/registry.py``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from .base import ArchConfig
from .mamba2_1_3b import CONFIG as _mamba2
from .mixtral_8x7b import CONFIG as _mixtral
from .olmoe_1b_7b import CONFIG as _olmoe
from .pixtral_12b import CONFIG as _pixtral
from .qwen1_5_4b import CONFIG as _qwen15
from .qwen2_0_5b import CONFIG as _qwen2
from .qwen3_14b import CONFIG as _qwen3
from .seamless_m4t_medium import CONFIG as _seamless
from .yi_9b import CONFIG as _yi
from .zamba2_7b import CONFIG as _zamba2

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in [
        _mamba2, _pixtral, _seamless, _olmoe, _yi, _qwen15, _zamba2,
        _mixtral, _qwen2, _qwen3,
    ]
}


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    s.name: s
    for s in [
        InputShape("train_4k", 4_096, 256, "train"),
        InputShape("prefill_32k", 32_768, 32, "prefill"),
        InputShape("decode_32k", 32_768, 128, "decode"),
        InputShape("long_500k", 524_288, 1, "decode"),
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> InputShape:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]
