"""Architecture registry of the port: the paper's ``llama3-8b``, the four
dense decoders (``phi3-medium-14b``, ``qwen1.5-110b`` with QKV bias,
``deepseek-7b`` with 32 KV heads, ``command-r-35b`` with a tied head), the
MoE ``llama4-maverick-400b-a17b``, ``deepseek-v2-236b`` (MLA attention
over a compressed latent cache, and MoE), the attention-free Mamba2
``mamba2-1.3b`` and the hybrid ``jamba-1.5-large-398b`` (one attention
layer in eight, the rest Mamba2; MoE on every other layer), the VLM
``llama-3.2-vision-90b`` (a cross-attention layer every fifth) and the
encoder-decoder ``whisper-base`` (every decoder layer cross-attends to a
bidirectional encoder's output): the JAX package's eleven ids.
``get_config`` returns the full published config, ``get_reduced`` the small
same-family variant used by the CPU tests."""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "mamba2-1.3b",
    "phi3-medium-14b",
    "qwen1.5-110b",
    "deepseek-7b",
    "llama4-maverick-400b-a17b",
    "deepseek-v2-236b",
    "whisper-base",
    "command-r-35b",
    "jamba-1.5-large-398b",
    "llama-3.2-vision-90b",
    # the paper's own base model
    "llama3-8b",
]

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _load(name: str):
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[name]}")


def get_config(name: str):
    cfg = _load(name).CONFIG
    cfg.validate()
    return cfg


def get_reduced(name: str):
    cfg = _load(name).REDUCED
    cfg.validate()
    return cfg
