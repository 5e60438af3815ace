"""Symmetric int8 quantization of one tensor: the host KV tier's int8
residency (``PagedCacheManager(host_quant=True)``).

Port of ``quantize_leaf``, ``dequant_leaf`` and ``is_q8`` of
``repro.models.quant``, on tensors.  A quantized leaf is ``{"_q8": int8,
"_qs": float32}``, the scale taken over axis ``-2`` (kept as a size-1 axis):
in the paged pool ``[L, n_blocks, bs, g, hd]`` that is the KV-head axis, the
axis the JAX package reduces.  Rounding is half to even (``torch.round``, as
``jnp.round``).  Int8 weight-only serving (``quantize_params``) is not
ported.
"""
from __future__ import annotations

from typing import Dict

import torch


def is_q8(node) -> bool:
    return isinstance(node, dict) and "_q8" in node


def quantize_leaf(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    w32 = w.float()
    s = torch.clamp(w32.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return {"_q8": q, "_qs": s}


def dequant_leaf(node: Dict[str, torch.Tensor],
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (node["_q8"].float() * node["_qs"]).to(dtype)
