"""Multi-LoRA adapter algebra.

A LoRA bank holds ``n_slots`` adapters stacked on a leading axis so that one
kernel call serves every token of a mixed-adapter stream (the paper's SMLM
design).  Per-token ids select the adapter; ``-1`` (or any out-of-range id)
means base model only.  The port keeps the bank per layer::

    bank = {"layers": [{target: {"a": [n, d_in, r], "b": [n, r, d_out]}}]}

Static scaling (alpha/r) is folded into ``b``; dynamic per-request scaling
arrives as the per-slot ``scale`` vector.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ops import LoraRoute


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    n_slots: int = 4            # resident adapter slots
    r: int = 8
    alpha: float = 16.0
    dropout: float = 0.05       # train-time only
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo", "wg", "wu", "wd",
                                "wdkv", "in_x", "in_z", "out_proj")

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def lora_apply_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   ids: torch.Tensor, scale_t: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """One-hot mixed multi-LoRA matmul, exact per token (the oracle the
    dispatch is held to).  x: [T, d_in]; a: [n, d_in, r]; b: [n, r, d_out];
    ids: [T]; out-of-range ids give a zero row."""
    n = a.shape[0]
    onehot = (ids.long()[:, None] == torch.arange(n, device=x.device)
              ).to(x.dtype)
    if scale_t is not None:
        onehot = onehot * scale_t[:, None].to(x.dtype)
    xa = torch.einsum("td,ndr->tnr", x, a.to(x.dtype)) * onehot[:, :, None]
    return torch.einsum("tnr,nro->to", xa, b.to(x.dtype))


def lora_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               ids: torch.Tensor, scale_t: Optional[torch.Tensor] = None, *,
               n_head: int, block_t: int) -> torch.Tensor:
    """Kernel dispatch: the first ``n_head`` tokens (ft+pf, tile-aligned at
    the planner's ``block_t``) through SMLM, the rest through BGMV."""
    rt = ops.route(ids, scale_t, a.shape[0], n_head, block_t)
    return ops.lora_apply(x, a, b, rt)


def dense(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
          lora: Optional[Dict[str, torch.Tensor]],
          rt: Optional[LoraRoute]) -> torch.Tensor:
    """Joint base + multi-LoRA linear over the flattened stream [T, d]: one
    base product (``torch.matmul``, which the JAX package leaves to XLA)
    plus one multi-LoRA kernel call per bucket."""
    y = x @ w
    if bias is not None:
        y = y + bias
    if lora is not None and rt is not None:
        y += ops.lora_apply(x, lora["a"], lora["b"], rt)
    return y


def init_lora_bank(targets, lcfg: LoRAConfig, n_layers: int,
                   generator: torch.Generator, device: torch.device,
                   dtype: torch.dtype, gaussian_b: bool = False) -> Dict:
    """Random bank for per-layer ``targets`` (name -> LoraTarget): ``a`` is
    normal / sqrt(d_in); ``b`` is zeros, or normal * 0.02 * alpha/r with
    ``gaussian_b`` (the paper's fully gaussian adapters)."""
    layers = []
    for _ in range(n_layers):
        d = {}
        for name, t in targets.items():
            a = torch.randn((lcfg.n_slots, t.d_in, lcfg.r),
                            generator=generator, device=device, dtype=dtype)
            a.mul_(1.0 / t.d_in ** 0.5)
            if gaussian_b:
                b = torch.randn((lcfg.n_slots, lcfg.r, t.d_out),
                                generator=generator, device=device,
                                dtype=dtype).mul_(0.02 * lcfg.scaling)
            else:
                b = torch.zeros((lcfg.n_slots, lcfg.r, t.d_out),
                                device=device, dtype=dtype)
            d[name] = {"a": a, "b": b}
        layers.append(d)
    return {"layers": layers}
