"""Device resolution for the port's entry points.

Entry points (``init_params``, ``AdapterStore``, ``UnifiedEngine``, the serve
CLI) default to ``cuda`` and raise when no GPU is present: they never drop to
the CPU on their own.  The CPU is used only when the caller asks for it.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without a visible GPU raises
    instead of silently becoming the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


def resolve_dtype(dtype: Union[str, torch.dtype, None],
                  default: str = "float32") -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype or default
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt

