"""Roofline terms from the analytical step cost (``models.costs``) on one
NVIDIA H100 SXM.

Hardware model, from NVIDIA's H100 Tensor Core GPU data sheet (SXM form
factor): 989 TFLOP/s dense bf16 (tensor cores, without sparsity), 67
TFLOP/s fp32 (CUDA cores), 3.35 TB/s HBM3, and 900 GB/s of NVLink 4
bandwidth counted both ways, so 450 GB/s per direction.  A card capped
below its 700 W limit runs slower than these peaks under load.

The JAX package reads FLOPs and bytes from a compiled XLA program and
collective bytes from its HLO text; eager PyTorch produces neither, so the
terms here come from ``step_cost`` alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12          # dense bf16 per card
PEAK_FLOPS_FP32 = 67e12      # fp32 per card (no tensor cores)
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per card and direction (NVLink 4)


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device FLOPs
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: float            # per-device collective operand bytes
    chips: int
    model_flops: float = 0.0     # 6*N*D (train) / 2*N*D (inference), global

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (per-device FLOPs x chips)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "chips": self.chips,
            "model_flops_global": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
        }
