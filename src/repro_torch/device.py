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
    """numpy array or tensor -> tensor.  A 2-byte void array is bf16:
    an ``ml_dtypes`` bfloat16 array, or the raw ``|V2`` bytes ``np.load``
    reads back from a checkpoint's bf16 leaf (numpy alone has no bf16).
    Its uint16 bits become a ``torch.bfloat16`` tensor, bit for bit."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.asarray(a)
        if a.dtype.kind == "V":
            if a.dtype.itemsize != 2:
                raise TypeError(f"a void array of dtype {a.dtype} is no "
                                "bf16 leaf (2 bytes an element)")
            t = torch.from_numpy(np.array(a.view(np.uint16))).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)
