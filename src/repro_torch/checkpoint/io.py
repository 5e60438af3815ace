"""The weight bridge: path-keyed numpy archives into port tensors.

The JAX package writes pytrees as npz archives whose keys are the pytree
paths joined by ``/`` (``repro.checkpoint.io.save_pytree``): ``embed``,
``blocks/{pos}/wq`` (leading ``n_periods`` axis, then the leaf's own
shape, e.g. MLA's 4-D ``blocks/0/wuk`` [P, c, h, dn]; one stack per
position of the block pattern), ``final_norm``,
``lm_head``; a LoRA bank adds ``/a`` and ``/b`` with ``n_slots`` after the
periods axis, and an int8 weight ``/_q8`` and ``/_qs``.  The functions here
split the periods axis into the port's per-layer lists: ``blocks/{pos}/
...[period]`` is port layer ``period * P + pos`` (``P`` positions), and a
nested leaf ``blocks/1/shared/wg`` is the layer's ``shared_wg``.  An
encoder's ``encoder/blocks/<leaf>`` ``[ne, ...]`` (int8 ``/_q8`` and
``/_qs`` too) becomes ``params["encoder"]["layers"][i][leaf]``, and
``encoder/final_norm`` its ``final_norm``.  int8 payloads and their fp32
scales keep their dtypes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, resolve_dtype

Flat = Dict[str, np.ndarray]
_SUB = ("_q8", "_qs", "a", "b")      # sub-leaves of a quantized / LoRA leaf


def load_npz(path: str) -> Flat:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _tensor(arr: np.ndarray, device, dtype,
            sub: Optional[str] = None) -> torch.Tensor:
    """An int8 payload stays int8 and its scale fp32."""
    dtype = {"_q8": torch.int8, "_qs": torch.float32}.get(sub, dtype)
    arr = np.asarray(arr)                 # a 0-d leaf (xgate) stays 0-d
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _leaf(rest: str) -> Tuple[str, Optional[str]]:
    """``shared/wg/_q8`` -> (``shared_wg``, ``_q8``); ``wq`` -> (``wq``,
    None)."""
    parts = rest.split("/")
    sub = parts.pop() if len(parts) > 1 and parts[-1] in _SUB else None
    return "_".join(parts), sub


def _per_layer(flat: Flat, device, dtype) -> List[Dict]:
    """``blocks/{pos}/<rest>`` -> per-layer ``{leaf: tensor}`` or ``{leaf:
    {sub: tensor}}``, layer ``period * P + pos``."""
    by_pos: Dict[int, Dict[str, np.ndarray]] = {}
    for k, v in flat.items():
        if k.startswith("blocks/"):
            _, pos, rest = k.split("/", 2)
            by_pos.setdefault(int(pos), {})[rest] = v
    P = len(by_pos)
    if sorted(by_pos) != list(range(P)):
        raise ValueError(f"block positions {sorted(by_pos)} are not 0..{P-1}")
    periods = {v.shape[0] for d in by_pos.values() for v in d.values()}
    if len(periods) != 1:
        raise ValueError(f"inconsistent periods axes {sorted(periods)}")
    layers: List[Dict] = [{} for _ in range(periods.pop() * P)]
    for pos, leaves in by_pos.items():
        for rest, v in leaves.items():
            name, sub = _leaf(rest)
            for period in range(v.shape[0]):
                x = _tensor(v[period], device, dtype, sub)
                layer = layers[period * P + pos]
                if sub is None:
                    layer[name] = x
                else:
                    layer.setdefault(name, {})[sub] = x
    return layers


def _top(flat: Flat, key: str, device, dtype):
    if f"{key}/_q8" in flat:
        return {s: _tensor(flat[f"{key}/{s}"], device, dtype, s)
                for s in ("_q8", "_qs")}
    return _tensor(flat[key], device, dtype)


def params_from_numpy(flat: Flat, device: DeviceLike = None,
                      dtype=None) -> Dict:
    """Base parameters in the port's per-layer layout; int8 leaves stay
    ``{"_q8", "_qs"}``.  The float dtype defaults to ``final_norm``'s."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype, str(flat["final_norm"].dtype))
    params = {"embed": _top(flat, "embed", dev, dt),
              "layers": _per_layer(flat, dev, dt),
              "final_norm": _tensor(flat["final_norm"], dev, dt)}
    if "lm_head" in flat or "lm_head/_q8" in flat:
        params["lm_head"] = _top(flat, "lm_head", dev, dt)
    if "encoder/final_norm" in flat:
        # encoder layer i is period i of a one-position pattern
        pre = "encoder/blocks/"
        layers = _per_layer({f"blocks/0/{k[len(pre):]}": v
                             for k, v in flat.items() if k.startswith(pre)},
                            dev, dt)
        params["encoder"] = {"layers": layers, "final_norm": _tensor(
            flat["encoder/final_norm"], dev, dt)}
    return params


def bank_from_numpy(flat: Flat, device: DeviceLike = None,
                    dtype=None) -> Dict:
    """A LoRA bank (``blocks/{pos}/<t>/a`` = ``[P, n, d_in, r]``) or one
    adapter (``[P, d_in, r]``) as ``{"layers": [{t: {"a", "b"}}]}``."""
    dev = resolve_device(device)
    any_leaf = next(iter(flat.values()))
    dt = resolve_dtype(dtype, str(any_leaf.dtype))
    return {"layers": _per_layer(flat, dev, dt)}
