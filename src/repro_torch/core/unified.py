"""Step builders: the unit the runtime executes each tick.

PyTorch runs eagerly, so the JAX package's jitted step cache has no
counterpart: ``make_forward_step`` returns a plain closure over the config
and the planner's SMLM tile, run under ``torch.inference_mode``.  Nothing
keys on ``kernels.autotune.table_version()``: the model asks for its split
choice on every forward.  The grad and optimizer steps come with the
training slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.configs import ModelConfig
from repro_torch.models.model import unified_forward
from repro_torch.models.stream import ModelOut, UnifiedBatch


def make_forward_step(cfg: ModelConfig, *, block_t: int,
                      attn_chunk: int = 0) -> Callable:
    """Inference-only unified step (prefill + decode or verify)."""

    def step(base, bank, scale, batch: UnifiedBatch, cache) -> ModelOut:
        with torch.inference_mode():
            return unified_forward(cfg, base, batch, cache, loras=bank,
                                   lora_scale=scale, block_t=block_t,
                                   attn_chunk=attn_chunk)

    return step
