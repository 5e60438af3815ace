"""Architecture registry of the port: ``llama3-8b`` only (the serving
slice's model).  ``get_config`` returns the full published config,
``get_reduced`` the small same-family variant used by the CPU tests."""
from __future__ import annotations

from repro_torch.configs import llama3_8b

ARCH_IDS = ["llama3-8b"]
_MOD = {"llama3-8b": llama3_8b}


def _load(name: str):
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return _MOD[name]


def get_config(name: str):
    cfg = _load(name).CONFIG
    cfg.validate()
    return cfg


def get_reduced(name: str):
    cfg = _load(name).REDUCED
    cfg.validate()
    return cfg
