"""Where the port's entry points run, and how arrays reach it.

Every entry point takes ``device`` and defaults to ``"cuda"``; a CUDA
device with no card present raises instead of falling back to the CPU.
Tests pass ``device="cpu"`` to run the plain torch paths.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device with no card
    present raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run the plain torch path")
    return dev


def as_tensor(a, device, dtype=None) -> torch.Tensor:
    """numpy array (bf16 included, through float32) or tensor -> tensor."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.asarray(a)
        if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        t = torch.from_numpy(np.array(a))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)
