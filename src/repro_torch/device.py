"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the default
is ``cuda``, and asking for ``cuda`` where no card is present raises instead
of falling back quietly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(name: Optional[str]) -> torch.dtype:
    """``ArchConfig.dtype`` string ("bfloat16", "float32") -> torch dtype."""
    dt = getattr(torch, name or "", None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
