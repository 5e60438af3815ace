"""Symmetric int8 quantization: the host KV tier's int8 residency
(``PagedCacheManager(host_quant=True)``) and int8 weight-only serving.

Port of ``repro.models.quant``, on tensors.  A quantized leaf is ``{"_q8":
int8, "_qs": float32}``, the scale taken over axis ``-2`` (kept as a size-1
axis): for a weight ``[..., d_in, d_out]`` one scale per output channel; in
the paged pool ``[L, n_blocks, bs, g, hd]`` the KV-head axis, the axis the
JAX package reduces.  Rounding is half to even (``torch.round``, as
``jnp.round``).

Weight-only serving quantizes the big matmul weights (``_eligible``, the
JAX package's rule on the JAX layout's shapes, periods axis included):
norms, biases and small matrices stay in their dtype, and the LoRA bank is
never quantized.  An MLA up projection ``wuk`` / ``wuv`` [c, h, d] (JAX
layout ``[P, c, h, d]``) is eligible when ``h`` and ``d`` are at least 64:
its scales group over ``h`` for each row of ``c``, as the JAX package's.
A cross layer's ``xwq`` / ``xwk`` / ``xwv`` / ``xwo`` are eligible by the
same rule (``xln`` and the scalar ``xgate`` never), and so are an
encoder's matrices (JAX layout ``[ne, d_in, d_out]``).  The forward
dequantizes ``embed``, ``lm_head`` and the encoder at its top and each
layer's leaves inside the layer loop, so device memory holds
int8 and at most one layer's dequantized weights at a time; a MoE layer's
expert stacks dequantize only the routed experts' slices
(``repro_torch.models.moe``).  Dequant is elementwise PyTorch, as the JAX
package leaves it to XLA.

Under a mesh (``quant_shardings``, JAX's rule in the port's per-layer
tree) an int8 leaf's ``_q8`` payload takes the float leaf's spec and its
``_qs`` scales the same spec with the reduced input axis replicated: a
scale spans the whole input axis, so a leaf is quantized whole and then
cut (``checkpoint.io.init_sharded_params``), never quantized per shard.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.configs import ModelConfig
from repro_torch.models.schema import Leaf, encoder_shapes, layer_shapes, \
    top_leaves


def _eligible(leaf: Leaf, shape: Tuple[int, ...]) -> bool:
    """Quantize big matmul weights only (gaussian-init, >=2D, wide); the
    shape is the JAX layout's (a block leaf's periods axis first)."""
    return (leaf.init == "normal" and len(shape) >= 2
            and shape[-1] >= 64 and shape[-2] >= 64)


def is_q8(node) -> bool:
    return isinstance(node, dict) and "_q8" in node


def quantize_leaf(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    w32 = w.float()
    s = torch.clamp(w32.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return {"_q8": q, "_qs": s}


# elements of the largest matrix quantized at once: a larger one (a
# full-width embedding or head) is quantized in blocks of whole columns,
# which hold their own scales, so the fp32 transients stay near 1 GiB
_CHUNK = 1 << 28


def _columns(shape) -> range:
    """Starts of the column blocks of a 2D leaf of ``shape``."""
    return range(0, shape[-1], max(1, _CHUNK // shape[-2]))


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``quantize_leaf`` one matrix at a time along the leading axes, and a
    large matrix one column block at a time, into preallocated outputs: the
    same values with a bounded fp32 transient (an expert stack or a
    full-width head in fp32 would be 4x its int8 payload)."""
    if w.dim() <= 2 and w.numel() <= _CHUNK:
        return quantize_leaf(w)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((*w.shape[:-2], 1, w.shape[-1]), dtype=torch.float32,
                    device=w.device)
    if w.dim() == 2:
        cols = _columns(w.shape)
        for c in cols:
            node = quantize_leaf(w[:, c:c + cols.step])
            q[:, c:c + cols.step] = node["_q8"]
            s[:, c:c + cols.step] = node["_qs"]
        return {"_q8": q, "_qs": s}
    for i in range(w.shape[0]):
        node = quantize_weight(w[i])
        q[i], s[i] = node["_q8"], node["_qs"]
    return {"_q8": q, "_qs": s}


def dequant_leaf(node: Dict[str, torch.Tensor],
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``(q8 as f32) * scale``, rounded to ``dtype``: one elementwise pass
    (the product is taken in fp32, the common type, and rounded as it is
    written), so a weight costs 1 byte read and 2 written, with no fp32
    copy of the leaf."""
    q, s = node["_q8"], node["_qs"]
    return torch.mul(q, s, out=torch.empty(q.shape, dtype=dtype,
                                           device=q.device))


def quantize_params(cfg: ModelConfig, params: Dict) -> Dict:
    """Quantize the eligible leaves of a materialised param tree (the
    port's per-layer layout)."""
    out = dict(params)
    for name, leaf in top_leaves(cfg).items():
        if _eligible(leaf, leaf.shape):
            out[name] = quantize_weight(params[name])
    out["layers"] = [
        {k: (quantize_weight(layer[k])
             if _eligible(leaf, (cfg.n_periods, *leaf.shape)) else layer[k])
         for k, leaf in layer_shapes(cfg, li).items()}
        for li, layer in enumerate(params["layers"])]
    if cfg.encoder is not None:
        ne = cfg.encoder.n_layers
        out["encoder"] = dict(params["encoder"], layers=[
            {k: (quantize_weight(layer[k])
                 if _eligible(leaf, (ne, *leaf.shape)) else layer[k])
             for k, leaf in encoder_shapes(cfg).items()}
            for layer in params["encoder"]["layers"]])
    return out


def q8_spec(spec: tuple, ndim: int) -> Dict[str, tuple]:
    """The specs of an int8 leaf whose float leaf has ``spec`` over
    ``ndim`` dims: ``_q8`` inherits it, ``_qs`` drops the reduced input
    axis (``-2``, of size 1 there)."""
    parts = tuple(spec) + (None,) * (ndim - len(spec))
    return {"_q8": parts, "_qs": parts[:-2] + (None, parts[-1])}


def quant_shardings(cfg: ModelConfig, mesh, strategy: str = "fsdp_tp"
                    ) -> Dict:
    """``distributed.sharding.param_shardings`` for the tree
    ``quantize_params`` makes (JAX's ``quant_shardings``): every eligible
    leaf's spec becomes ``q8_spec``'s pair."""
    from repro_torch.distributed.sharding import param_shardings
    specs = param_shardings(cfg, mesh, strategy)

    def walk(sp, leaves, lead):
        return {k: (q8_spec(sp[k], len(leaf.shape))
                    if _eligible(leaf, (*lead, *leaf.shape)) else sp[k])
                for k, leaf in leaves.items()}

    out = dict(specs)
    out.update(walk(specs, top_leaves(cfg), ()))
    out["layers"] = [walk(sp, layer_shapes(cfg, li), (cfg.n_periods,))
                     for li, sp in enumerate(specs["layers"])]
    if cfg.encoder is not None:
        ne = cfg.encoder.n_layers
        out["encoder"] = dict(specs["encoder"], layers=[
            walk(sp, encoder_shapes(cfg), (ne,))
            for sp in specs["encoder"]["layers"]])
    return out


def dequant_tree(node, dtype: torch.dtype = torch.bfloat16):
    """Dequantize every ``_q8`` leaf of a (sub)tree; identity on a tree
    without one."""
    if is_q8(node):
        return dequant_leaf(node, dtype)
    if isinstance(node, dict):
        return {k: dequant_tree(v, dtype) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(dequant_tree(v, dtype) for v in node)
    return node


def has_q8(tree) -> bool:
    if is_q8(tree):
        return True
    if isinstance(tree, dict):
        return any(has_q8(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(has_q8(v) for v in tree)
    return False
