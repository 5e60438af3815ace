"""The weight bridge: path-keyed numpy archives to and from port tensors.

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

The writer inverts the reader (``params_to_numpy``, ``bank_to_numpy``:
layer ``period * P + pos`` restacked into ``blocks/{pos}[period]``,
``shared_wg`` back to ``shared/wg``) and writes what JAX's ``save_pytree`` /
``serialize_pytree`` write for the same tree (``save_npz``,
``serialize_npz``): the same keys in the same order (JAX flattens a dict in
sorted key order and the ``blocks`` tuple by position), shapes and dtypes.
A bf16 leaf is written as its raw 2-byte words (``|V2``, what numpy saves
for a JAX bf16 array) and read back as bf16; JAX's own ``load_pytree``
cannot cast such a leaf, so bf16 archives cross only into the port.  So a
bank or an adapter fine-tuned on the card, or a voided adapter
(``VirtualModel.void``), can be saved and migrated to a JAX runtime and
back.
"""
from __future__ import annotations

import io
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, resolve_dtype
from repro_torch.models.configs import ModelConfig
from repro_torch.models.schema import SHARED

Flat = Dict[str, np.ndarray]
_SUB = ("_q8", "_qs", "a", "b")      # sub-leaves of a quantized / LoRA leaf
_BF16 = np.dtype("V2")               # how numpy holds a bf16 leaf


def load_npz(path) -> Flat:
    """The arrays of an npz archive (a path or a file object)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def deserialize_npz(blob: bytes) -> Flat:
    """The arrays of an in-memory npz blob (``serialize_npz``, or JAX's
    ``serialize_pytree``)."""
    return load_npz(io.BytesIO(blob))


def save_npz(path: str, flat: Flat) -> int:
    """Write ``flat`` to ``path`` as JAX's ``save_pytree`` does.  Returns
    the bytes written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    return os.path.getsize(path)


def serialize_npz(flat: Flat) -> bytes:
    """``flat`` as an in-memory npz blob (a migration payload), as JAX's
    ``serialize_pytree`` writes it."""
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16 else str(arr.dtype)


def _tensor(arr: np.ndarray, device, dtype,
            sub: Optional[str] = None) -> torch.Tensor:
    """An int8 payload stays int8 and its scale fp32; raw 2-byte words are
    bf16."""
    dtype = {"_q8": torch.int8, "_qs": torch.float32}.get(sub, dtype)
    arr = np.asarray(arr)                 # a 0-d leaf (xgate) stays 0-d
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    if arr.dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device=device, dtype=dtype)
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _array(x: torch.Tensor) -> np.ndarray:
    """A host copy of ``x`` as JAX's ``np.asarray`` gives it: bf16 as its
    raw 2-byte words."""
    x = x.detach().to("cpu", copy=True)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(_BF16)
    return x.numpy()


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
    dt = resolve_dtype(dtype, _dtype_name(flat["final_norm"]))
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
    dt = resolve_dtype(dtype, _dtype_name(any_leaf))
    return {"layers": _per_layer(flat, dev, dt)}


def _stacked(layers: List[Dict], P: int, prefix) -> List[Tuple[tuple,
                                                                np.ndarray]]:
    """Per-layer ``{leaf: tensor | {sub: tensor}}`` -> ``(path, array)``
    with layer ``period * P + pos`` at ``[period]`` of the stack of
    position ``pos``; ``prefix(pos)`` gives the path's head."""
    if len(layers) % P:
        raise ValueError(f"{len(layers)} layers are not periods of {P}")
    out = []
    for pos in range(P):
        group = layers[pos::P]
        for name, leaf in group[0].items():
            path = prefix(pos) + tuple(SHARED.get(name, name).split("/"))
            subs = sorted(leaf) if isinstance(leaf, dict) else [None]
            for sub in subs:
                arrs = [_array(layer[name] if sub is None
                               else layer[name][sub]) for layer in group]
                out.append((path if sub is None else path + (sub,),
                            np.stack(arrs)))
    return out


def _flat(items) -> Flat:
    """``(path, array)`` pairs in JAX's flattening order (dict keys sorted
    at every level, block positions in order) as ``{"a/b": array}``."""
    return {"/".join(str(c) for c in path): arr
            for path, arr in sorted(items, key=lambda kv: kv[0])}


def _top_items(x, path: tuple):
    if isinstance(x, dict):
        return [(path + (s,), _array(x[s])) for s in sorted(x)]
    return [(path, _array(x))]


def params_to_numpy(cfg: ModelConfig, params: Dict) -> Flat:
    """Port base parameters (int8 leaves as ``{"_q8", "_qs"}``) -> the flat
    arrays JAX's ``save_pytree`` writes for the same parameters; the
    inverse of ``params_from_numpy``."""
    items = _stacked(params["layers"], len(cfg.pattern),
                     lambda pos: ("blocks", pos))
    for key in ("embed", "final_norm", "lm_head"):
        if key in params:
            items += _top_items(params[key], (key,))
    if "encoder" in params:
        enc = params["encoder"]
        items += _stacked(enc["layers"], 1, lambda _: ("encoder", "blocks"))
        items += _top_items(enc["final_norm"], ("encoder", "final_norm"))
    return _flat(items)


def bank_to_numpy(cfg: ModelConfig, bank: Dict) -> Flat:
    """A LoRA bank (``[n, d_in, r]`` a layer: the ``n_slots`` axis lands
    after the periods axis) or one adapter (``[d_in, r]``) -> the flat
    arrays JAX's ``save_pytree`` writes for it; the inverse of
    ``bank_from_numpy``."""
    return _flat(_stacked(bank["layers"], len(cfg.pattern),
                          lambda pos: ("blocks", pos)))


# ---------------------------------------------------------------------------
# weights across a mesh: this rank's shards
# ---------------------------------------------------------------------------

def shard_params(params: Dict, cfg: ModelConfig, mesh,
                 strategy: str = "fsdp_tp") -> Dict:
    """This rank's shards of the whole ``params`` (``params_from_numpy``'s
    tree, e.g. from JAX's npz), cut as ``sharding.param_shardings`` says
    under ``strategy`` (``quant.quant_shardings`` for a tree with int8
    leaves, each quantized whole): every rank then computes its part of the
    function the whole weights compute."""
    from repro_torch.distributed.sharding import param_shardings, shard_tree
    from repro_torch.models import quant
    specs = (quant.quant_shardings(cfg, mesh, strategy)
             if quant.has_q8(params) else
             param_shardings(cfg, mesh, strategy))
    return shard_tree(params, specs, mesh)


def shard_bank(bank: Dict, mesh) -> Dict:
    """This rank's shards of a whole LoRA bank (``{"layers": [{target:
    {"a", "b"}}]}``), cut as ``sharding.lora_shardings`` says."""
    from repro_torch.distributed.sharding import lora_shardings, shard_tree
    return shard_tree(bank, lora_shardings(bank, mesh), mesh)


def shard_opt_state(state, mesh):
    """This rank's shards of a whole AdamW state (``training.optimizer.
    AdamWState``): the moments cut as the bank (``sharding.
    opt_shardings``), the per-slot step counts whole."""
    from repro_torch.distributed.sharding import opt_shardings, shard_tree
    specs = opt_shardings(state, mesh)
    return type(state)(m=shard_tree(state.m, specs.m, mesh),
                       v=shard_tree(state.v, specs.v, mesh), t=state.t)


def gather_bank(cfg: ModelConfig, bank: Dict, mesh) -> Dict:
    """The whole bank (or a bank-shaped tree: grads, moments) from every
    rank's shards of it (``shard_bank``'s inverse; the specs from the
    config, ``sharding.bank_shardings``)."""
    from repro_torch.distributed.sharding import bank_shardings, gather_tree
    return gather_tree(bank, bank_shardings(cfg, bank, mesh), mesh)


def gather_opt_state(cfg: ModelConfig, state, mesh):
    """The whole AdamW state from every rank's ``shard_opt_state``."""
    return type(state)(m=gather_bank(cfg, state.m, mesh),
                       v=gather_bank(cfg, state.v, mesh), t=state.t)


def init_sharded_params(cfg: ModelConfig, mesh, strategy: str,
                        generator: torch.Generator, device, dtype,
                        quantized: bool = False) -> Dict:
    """This rank's shards of ``schema.init_params(cfg, generator, device,
    dtype)`` (with ``quantized``: of ``quant.quantize_params`` of it):
    every leaf is drawn whole from ``generator``, in ``init_params``'
    order, quantized whole if eligible (a scale spans the whole input
    axis, which a shard may cut), cut to this rank's block and freed, one
    leaf at a time, so the ranks' shards are those of the one model a
    single card would draw from the same seed and the largest transient is
    one whole leaf."""
    from repro_torch.distributed.sharding import local_shard, \
        param_shardings, shard_tree
    from repro_torch.models import quant
    from repro_torch.models.schema import encoder_shapes, init_leaf, \
        layer_shapes, top_leaves
    specs = (quant.quant_shardings(cfg, mesh, strategy) if quantized
             else param_shardings(cfg, mesh, strategy))

    def draw(leaf, spec, lead=()):
        w = init_leaf(leaf, generator, device, dtype)
        if quantized and quant._eligible(leaf, (*lead, *leaf.shape)):
            w = quant.quantize_weight(w)
            return shard_tree(w, spec, mesh)
        return local_shard(w, spec, mesh)

    top = top_leaves(cfg)
    lead = (cfg.n_periods,)
    params = {"embed": draw(top["embed"], specs["embed"]),
              "layers": [{k: draw(leaf, specs["layers"][li][k], lead)
                          for k, leaf in layer_shapes(cfg, li).items()}
                         for li in range(cfg.n_layers)],
              "final_norm": torch.ones(cfg.d_model, device=device,
                                       dtype=dtype)}
    if "lm_head" in top:
        params["lm_head"] = draw(top["lm_head"], specs["lm_head"])
    if cfg.encoder is not None:
        ne = cfg.encoder.n_layers
        enc = specs["encoder"]["layers"]
        params["encoder"] = {
            "layers": [{k: draw(leaf, enc[i][k], (ne,))
                        for k, leaf in encoder_shapes(cfg).items()}
                       for i in range(ne)],
            "final_norm": torch.ones(cfg.d_model, device=device,
                                     dtype=dtype)}
    return params
