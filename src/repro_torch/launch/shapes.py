"""The assigned input shapes and the shape-driven config adaptation.

Port of the config half of ``repro.launch.shapes``: ``InputShape``,
``SHAPES``, ``LONG_CONTEXT_WINDOW``, ``DRYRUN_LORA``, ``has_attention`` and
``adapt_config``.  ``long_500k`` switches every config with an attention
layer to the sliding-window variant (window 8192 over a rolling dense row),
so a decode step over a 500k-token context stays sub-quadratic; Mamba2
layers keep their own O(1) state.  A windowed model serves on dense rows
only (the paged pool refuses it, as the JAX one does).

The JAX module's ``_aux_spec``, ``input_specs`` and ``abstract_model_state``
build abstract JAX values for the dry-run's lowering; they have no
counterpart here and go with the distribution slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.lora import LoRAConfig
from repro_torch.models.configs import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}

LONG_CONTEXT_WINDOW = 8192       # sliding window of attention configs at 500k
DRYRUN_LORA = LoRAConfig(n_slots=4, r=8)   # the paper's r=8


def has_attention(cfg: ModelConfig) -> bool:
    return any(k == "attn" for k in cfg.pattern)


def adapt_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """bf16 compute; at ``long_500k`` a sliding window of
    ``LONG_CONTEXT_WINDOW`` on every config with an attention layer."""
    cfg = cfg.replace(dtype="bfloat16")
    if shape.name == "long_500k" and has_attention(cfg):
        cfg = cfg.replace(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg
