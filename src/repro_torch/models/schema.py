"""Parameter schema of the port: shapes, initialisation and LoRA targets.

The JAX package stacks every block leaf over a leading ``n_periods`` axis so
it can ``lax.scan`` the decoder.  The port loops over layers instead, so its
parameters are per layer::

    {"embed": [V, d], "layers": [ {leaf: tensor, ...} per layer ],
     "final_norm": [d], "lm_head": [d, V]}

``param_shapes`` gives the JAX package's flat, path-keyed layout (``blocks/0/
wq`` with the periods axis first), which is what the weight bridge in
``repro_torch.checkpoint.io`` reads.  The serving slice covers the dense
attention + FFN family (llama3); MLA, Mamba, MoE, cross-attention and the
encoder belong to later slices and raise here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device, resolve_dtype
from repro_torch.models.configs import ModelConfig

# leaf -> (init, eligible LoRA target); init: normal | ones | zeros
_ATTN = {"ln1": "ones", "wq": "normal", "wk": "normal", "wv": "normal",
         "wo": "normal"}
_BIAS = {"bq": "zeros", "bk": "zeros", "bv": "zeros"}
_FFN = {"ln2": "ones", "wg": "normal", "wu": "normal", "wd": "normal"}
LORA_ELIGIBLE = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def check_supported(cfg: ModelConfig) -> None:
    """The serving slice ports the dense attention + FFN decoder only."""
    if (cfg.pattern != ("attn",) or cfg.mla is not None
            or cfg.moe is not None or cfg.ssm is not None
            or cfg.encoder is not None or cfg.cross_attn_every
            or cfg.sliding_window or cfg.d_ff <= 0):
        raise NotImplementedError(
            f"{cfg.name}: the port covers the dense attention+FFN decoder; "
            "MLA, Mamba, MoE, cross-attention, encoders and sliding windows "
            "come in later slices")


def layer_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Per-layer leaf -> (shape, init)."""
    check_supported(cfg)
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    shapes = {"ln1": (d,), "wq": (d, h * hd), "wk": (d, kv * hd),
              "wv": (d, kv * hd), "wo": (h * hd, d),
              "ln2": (d,), "wg": (d, f), "wu": (d, f), "wd": (f, d)}
    inits = dict(_ATTN, **_FFN)
    if cfg.qkv_bias:
        shapes.update(bq=(h * hd,), bk=(kv * hd,), bv=(kv * hd,))
        inits.update(_BIAS)
    return {k: (shapes[k], inits[k]) for k in shapes}


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat path -> shape in the JAX package's layout (periods axis first),
    the keys ``repro.checkpoint.io.save_pytree`` writes."""
    out = {"embed": (cfg.vocab, cfg.d_model)}
    for k, (shape, _) in layer_shapes(cfg).items():
        out[f"blocks/0/{k}"] = (cfg.n_periods, *shape)
    out["final_norm"] = (cfg.d_model,)
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.d_model, cfg.vocab)
    return out


def _init(shape, init: str, gen: torch.Generator, device, dtype,
          scale: float = 0.02) -> torch.Tensor:
    if init == "ones":
        return torch.ones(shape, device=device, dtype=dtype)
    if init == "zeros":
        return torch.zeros(shape, device=device, dtype=dtype)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = min(scale, fan_in ** -0.5)
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return t.mul_(std)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, dtype=None, seed: int = 0) -> Dict:
    """Random parameters, normal(0, min(0.02, fan_in^-1/2)) as the JAX
    schema draws them (from a torch generator, so not the same numbers: tests
    that need equal weights cross them over with the bridge).  Runs on
    ``cuda`` unless ``device="cpu"`` is passed."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype, cfg.dtype)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    leaves = layer_shapes(cfg)
    params = {"embed": _init((cfg.vocab, cfg.d_model), "normal", gen, dev,
                             dt),
              "layers": [{k: _init(shape, init, gen, dev, dt)
                          for k, (shape, init) in leaves.items()}
                         for _ in range(cfg.n_layers)],
              "final_norm": torch.ones(cfg.d_model, device=dev, dtype=dt)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _init((cfg.d_model, cfg.vocab), "normal", gen,
                                  dev, dt)
    return params


@dataclasses.dataclass(frozen=True)
class LoraTarget:
    d_in: int
    d_out: int


def lora_targets(cfg: ModelConfig, target_names: Tuple[str, ...]
                 ) -> Dict[str, LoraTarget]:
    """Per-layer LoRA targets: every eligible leaf named in
    ``target_names`` (the bank holds one entry per layer for each)."""
    out = {}
    for k, (shape, _) in layer_shapes(cfg).items():
        if k in LORA_ELIGIBLE and k in target_names:
            out[k] = LoraTarget(shape[0], shape[1])
    return out
