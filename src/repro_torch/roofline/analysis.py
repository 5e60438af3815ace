"""Roofline terms from the analytical step cost (``models.costs``) on one
NVIDIA H100 SXM.

Hardware model, from NVIDIA's H100 Tensor Core GPU data sheet (SXM form
factor): 989 TFLOP/s dense bf16 (tensor cores, without sparsity), 67
TFLOP/s fp32 (CUDA cores), 3.35 TB/s HBM3, and 900 GB/s of NVLink 4
bandwidth counted both ways, so 450 GB/s per direction.  A card capped
below its 700 W limit runs slower than these peaks under load.

The JAX package reads FLOPs and bytes from a compiled XLA program and
collective bytes from its HLO text; eager PyTorch produces neither.  Its
three readers have counterparts that read what an eager step does:
``collective_bytes`` reads the operand bytes that the sharded forward's
collectives recorded (``distributed.sharding.collective_log``),
``flop_count`` (``hlo_cost``'s counterpart) counts one call's FLOPs with
``torch.utils.flop_counter.FlopCounterMode``, and ``memory_summary``
reads the CUDA allocator around one call.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

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


def collective_bytes(log: Dict[str, int] = None) -> Dict[str, Dict[str, int]]:
    """Per-collective-kind operand bytes of this rank since the last
    ``sharding.reset_collective_log()`` (or of ``log``), as
    ``{"raw": {kind: bytes}, "scaled": {...}}`` like the JAX reader.  An
    eager program records every collective each time it runs, loop bodies
    included, so ``raw`` equals ``scaled`` (the JAX reader scales a while
    body's once-listed collectives by its trip count)."""
    from repro_torch.distributed.sharding import collective_log
    raw = dict(collective_log() if log is None else log)
    return {"raw": raw, "scaled": dict(raw)}


def flop_count(fn: Callable, *args, **kwargs) -> Dict:
    """The FLOPs of one call ``fn(*args, **kwargs)`` by
    ``torch.utils.flop_counter.FlopCounterMode`` (the counterpart of
    ``hlo_cost``): the matrix products and attention calls PyTorch
    dispatches, on meta tensors as well as real ones, so through the plain
    path (a hand-written kernel's launch is not an operator it sees).
    ``bytes_accessed`` is None: the counter counts no bytes.  Returns
    ``{"flops", "bytes_accessed", "by_op", "out"}``."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args, **kwargs)
    by_op = {str(op): int(n) for op, n in
             counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": None, "by_op": by_op, "out": out}


def memory_summary(fn: Callable, *args, state=None, device=None,
                   **kwargs) -> Dict:
    """The CUDA allocator around one call (the counterpart of the JAX
    reader of a compiled program's memory analysis): the bytes of the
    rank's local ``state`` (its weights, bank and cache: the arguments),
    the allocated bytes before the call, ``torch.cuda.max_memory_allocated``
    over it (``peak_bytes``) and that peak less the bytes before
    (``temp_bytes``).  Returns the dict with ``"out"``, the call's
    result."""
    import torch
    from repro_torch.training.optimizer import tree_leaves
    dev = device or torch.device("cuda", torch.cuda.current_device())
    arg = sum(x.numel() * x.element_size() for x in tree_leaves(state)
              if isinstance(x, torch.Tensor)) if state is not None else 0
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args, **kwargs)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    return {"argument_size_in_bytes": arg, "allocated_before_bytes": before,
            "peak_bytes": peak, "temp_bytes": peak - before, "out": out}
