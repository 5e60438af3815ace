"""The assigned input shapes and the shape-driven config adaptation.

Port of the config half of ``repro.launch.shapes``: ``InputShape``,
``SHAPES``, ``LONG_CONTEXT_WINDOW``, ``DRYRUN_LORA``, ``has_attention`` and
``adapt_config``.  ``long_500k`` switches every config with an attention
layer to the sliding-window variant (window 8192 over a rolling dense row),
so a decode step over a 500k-token context stays sub-quadratic; Mamba2
layers keep their own O(1) state.  A windowed model serves on dense rows
only (the paged pool refuses it, as the JAX one does).

The abstract half (``_aux_spec``, ``input_specs``, ``abstract_model_state``)
builds ``device="meta"`` tensors with the shapes and dtypes of the JAX
module's ``ShapeDtypeStruct`` trees, in the port's layouts: the per-layer
params and bank, and the cache of ``models.model.init_cache`` (dense rows,
``[L_kind, rows, ...]``).  Nothing is allocated; the sharding rules and
``roofline.analysis.flop_count`` read them.  The dry run that lowers a step
on them at the production mesh is not ported yet (``ROADMAP.md``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.lora import LoRAConfig
from repro_torch.device import resolve_dtype
from repro_torch.models.configs import ModelConfig
from repro_torch.models.schema import encoder_shapes, layer_shapes, \
    lora_targets, top_leaves
from repro_torch.models.stream import DECBatch, FTBatch, PFBatch, \
    UnifiedBatch

META = torch.device("meta")


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


def _i32(shape):
    return torch.empty(shape, dtype=torch.int32, device=META)


def _f(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


def _bool(shape):
    return torch.empty(shape, dtype=torch.bool, device=META)


def _aux_spec(cfg: ModelConfig, b: int) -> Optional[torch.Tensor]:
    """The modality front end's stand-in: precomputed frame/patch
    embeddings [b, F, d], bf16."""
    if cfg.encoder is not None:
        return _f((b, cfg.encoder.n_frames, cfg.d_model))
    if cfg.cross_attn_every:
        return _f((b, cfg.n_img_tokens, cfg.d_model))
    return None


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict:
    """Meta inputs of one step at ``shape``: ``{"batch": UnifiedBatch,
    "cache": dense-row cache or None}``; decode is ONE token per row over a
    ``seq_len`` cache."""
    from repro_torch.models.model import init_cache
    b, s = shape.global_batch, shape.seq_len
    dt = resolve_dtype(None, cfg.dtype)
    if shape.kind == "train":
        ft = FTBatch(tokens=_i32((b, s)), mask=_bool((b, s)),
                     labels=_i32((b, s)), adapter=_i32((b,)),
                     weight=_f((b,), torch.float32),
                     aux_embed=_aux_spec(cfg, b))
        return {"batch": UnifiedBatch(ft=ft), "cache": None}
    cache = init_cache(cfg, b, s, META, dt)
    if shape.kind == "prefill":
        pf = PFBatch(tokens=_i32((b, s)), length=_i32((b,)),
                     adapter=_i32((b,)), aux_embed=_aux_spec(cfg, b))
        return {"batch": UnifiedBatch(pf=pf), "cache": cache}
    dec = DECBatch(tokens=_i32((b,)), pos=_i32((b,)), adapter=_i32((b,)))
    return {"batch": UnifiedBatch(dec=dec), "cache": cache}


def abstract_model_state(cfg: ModelConfig, lcfg: LoRAConfig = DRYRUN_LORA):
    """(params, LoRA bank, scale) as meta tensors in the port's trees, the
    params and bank in ``cfg.dtype``, the scale fp32 [n_slots]."""
    dt = resolve_dtype(None, cfg.dtype)

    def leaves(d):
        return {k: _f(leaf.shape, dt) for k, leaf in d.items()}

    params = leaves(top_leaves(cfg))
    params["layers"] = [leaves(layer_shapes(cfg, li))
                        for li in range(cfg.n_layers)]
    params["final_norm"] = _f((cfg.d_model,), dt)
    if cfg.encoder is not None:
        params["encoder"] = {
            "layers": [leaves(encoder_shapes(cfg))
                       for _ in range(cfg.encoder.n_layers)],
            "final_norm": _f((cfg.d_model,), dt)}
    bank = {"layers": [
        {name: {"a": _f((lcfg.n_slots, t.d_in, lcfg.r), dt),
                "b": _f((lcfg.n_slots, lcfg.r, t.d_out), dt)}
         for name, t in layer.items()}
        for layer in lora_targets(cfg, lcfg.targets)]}
    scale = _f((lcfg.n_slots,), torch.float32)
    return params, bank, scale
