"""Architecture registry of the port: the archs it serves so far."""

from __future__ import annotations

from typing import Dict

from .base import ArchConfig
from .qwen2_0_5b import CONFIG as _qwen2

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [_qwen2]}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]
