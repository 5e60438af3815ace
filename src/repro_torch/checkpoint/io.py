"""The weight bridge: path-keyed numpy archives into port tensors.

The JAX package writes pytrees as npz archives whose keys are the pytree
paths joined by ``/`` (``repro.checkpoint.io.save_pytree``): ``embed``,
``blocks/0/wq`` (leading ``n_periods`` axis, then the leaf's own shape),
``final_norm``, ``lm_head``; a LoRA bank adds ``/a`` and ``/b`` with
``n_slots`` after the periods axis.  For llama3 the block pattern is
``("attn",)``, so ``blocks/0/<leaf>`` carries one entry per layer.  The
functions here split that axis into the port's per-layer lists.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, resolve_dtype

Flat = Dict[str, np.ndarray]


def load_npz(path: str) -> Flat:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _tensor(arr: np.ndarray, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device,
                                                          dtype=dtype)


def _blocks(flat: Flat) -> Dict[str, np.ndarray]:
    """``blocks/0/<rest>`` -> ``<rest>``; only one pattern position is
    supported (the dense decoder)."""
    out = {}
    for k, v in flat.items():
        if not k.startswith("blocks/"):
            continue
        _, pos, rest = k.split("/", 2)
        if pos != "0":
            raise NotImplementedError(
                f"{k}: multi-position block patterns are not ported")
        out[rest] = v
    return out


def _per_layer(blocks: Dict[str, np.ndarray], device, dtype
               ) -> List[Dict[str, torch.Tensor]]:
    n_layers = {v.shape[0] for v in blocks.values()}
    if len(n_layers) != 1:
        raise ValueError(f"inconsistent periods axes {sorted(n_layers)}")
    return [{k: _tensor(v[i], device, dtype) for k, v in blocks.items()}
            for i in range(n_layers.pop())]


def params_from_numpy(flat: Flat, device: DeviceLike = None,
                      dtype=None) -> Dict:
    """Base parameters in the port's per-layer layout."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype, str(flat["embed"].dtype))
    params = {"embed": _tensor(flat["embed"], dev, dt),
              "layers": _per_layer(_blocks(flat), dev, dt),
              "final_norm": _tensor(flat["final_norm"], dev, dt)}
    if "lm_head" in flat:
        params["lm_head"] = _tensor(flat["lm_head"], dev, dt)
    return params


def _nest(layers: List[Dict[str, torch.Tensor]]) -> List[Dict]:
    """``{"wq/a": t, "wq/b": t}`` -> ``{"wq": {"a": t, "b": t}}``."""
    out = []
    for d in layers:
        nd: Dict[str, Dict[str, torch.Tensor]] = {}
        for k, v in d.items():
            tgt, ab = k.split("/")
            nd.setdefault(tgt, {})[ab] = v
        out.append(nd)
    return out


def bank_from_numpy(flat: Flat, device: DeviceLike = None,
                    dtype=None) -> Dict:
    """A LoRA bank (``blocks/0/<t>/a`` = ``[L, n, d_in, r]``) or one
    adapter (``[L, d_in, r]``) as ``{"layers": [{t: {"a", "b"}}]}``."""
    dev = resolve_device(device)
    any_leaf = next(iter(flat.values()))
    dt = resolve_dtype(dtype, str(any_leaf.dtype))
    return {"layers": _nest(_per_layer(_blocks(flat), dev, dt))}
