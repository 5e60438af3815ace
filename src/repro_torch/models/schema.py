"""Parameter schema of the port: shapes, initialisation and LoRA targets.

The JAX package stacks every block leaf over a leading ``n_periods`` axis so
it can ``lax.scan`` the decoder, one stack per position of the block
pattern.  The port loops over layers instead, so its parameters are per
layer::

    {"embed": [V, d], "layers": [ {leaf: tensor, ...} per layer ],
     "final_norm": [d], "lm_head": [d, V]}

Layer ``li`` is pattern position ``li % P`` of period ``li // P`` (``P =
len(cfg.pattern)``), the order of the JAX scan.  Its FFN is a mixture of
experts when ``cfg.is_moe_layer(li % P)``: a ``router`` [d, E], the expert
stacks ``w_gate`` / ``w_up`` [E, d, f] and ``w_down`` [E, f, d], and, with
shared experts, ``shared_wg`` / ``shared_wu`` / ``shared_wd`` (the JAX
package's nested ``shared/{wg,wu,wd}``, flattened so a LoRA bank key never
collides with a dense layer's ``wg``).  Otherwise it is the dense SwiGLU
``wg`` / ``wu`` / ``wd``.

``param_shapes`` gives the JAX package's flat, path-keyed layout (``blocks/
{pos}/wq`` with the periods axis first, ``blocks/1/shared/wg``), which is
what the weight bridge in ``repro_torch.checkpoint.io`` reads.

An MLA layer (``cfg.mla``, DeepSeek-V2) has in place of ``wq``/``wk``/
``wv``/``wo`` the JAX schema's ``wq`` [d, h*(dn+dr)], the down projection
``wdkv`` [d, c+dr] (LoRA key ``wdkv``), the up projections ``wuk`` [c, h,
dn] and ``wuv`` [c, h, dv] (no LoRA; fan-in ``shape[-2] = h``, as the JAX
schema draws them) and ``wo`` [h*dv, d].  The port covers attention
decoders (GQA or MLA) with dense or MoE FFNs; Mamba, cross-attention,
encoders and sliding windows raise here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device, resolve_dtype
from repro_torch.models.configs import ModelConfig

# a shared expert's leaves: port key -> the JAX package's nested path
SHARED = {"shared_wg": "shared/wg", "shared_wu": "shared/wu",
          "shared_wd": "shared/wd"}


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One per-layer leaf: ``init`` normal | ones | zeros; ``scale`` caps
    the normal's std (min(scale, fan_in^-1/2), as the JAX schema draws);
    ``lora``: an eligible LoRA target, by the key name ``name``."""
    shape: Tuple[int, ...]
    init: str = "normal"
    scale: float = 0.02
    lora: str = ""


def check_supported(cfg: ModelConfig) -> None:
    """Attention decoders (GQA or MLA) with dense or MoE FFNs: any block
    pattern of ``"attn"`` positions."""
    if (any(k != "attn" for k in cfg.pattern)
            or cfg.ssm is not None or cfg.encoder is not None
            or cfg.cross_attn_every or cfg.sliding_window
            or any(not cfg.has_ffn(p) for p in range(len(cfg.pattern)))):
        raise NotImplementedError(
            f"{cfg.name}: the port covers attention decoders (GQA or MLA) "
            "with dense or MoE FFNs; Mamba, cross-attention, encoders and "
            "sliding windows are not ported")


def is_moe(cfg: ModelConfig, li: int) -> bool:
    """Whether layer ``li``'s FFN is a mixture of experts."""
    return cfg.is_moe_layer(li % len(cfg.pattern))


def layer_shapes(cfg: ModelConfig, li: int = 0) -> Dict[str, Leaf]:
    """Layer ``li``'s leaves, in the JAX schema's order."""
    check_supported(cfg)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = {"ln1": Leaf((d,), "ones")}
    if cfg.mla is not None:
        m = cfg.mla
        out.update(
            wq=Leaf((d, h * (m.qk_nope_dim + m.qk_rope_dim)), lora="wq"),
            wdkv=Leaf((d, m.kv_lora_rank + m.qk_rope_dim), lora="wdkv"),
            wuk=Leaf((m.kv_lora_rank, h, m.qk_nope_dim)),
            wuv=Leaf((m.kv_lora_rank, h, m.v_head_dim)),
            wo=Leaf((h * m.v_head_dim, d), lora="wo"))
    else:
        out.update(wq=Leaf((d, h * hd), lora="wq"),
                   wk=Leaf((d, kv * hd), lora="wk"),
                   wv=Leaf((d, kv * hd), lora="wv"),
                   wo=Leaf((h * hd, d), lora="wo"))
    if cfg.qkv_bias and cfg.mla is None:
        out.update(bq=Leaf((h * hd,), "zeros"), bk=Leaf((kv * hd,), "zeros"),
                   bv=Leaf((kv * hd,), "zeros"))
    out["ln2"] = Leaf((d,), "ones")
    if is_moe(cfg, li):
        e = cfg.moe
        E, f = e.num_experts, e.d_ff_expert
        out.update(router=Leaf((d, E), scale=0.006),
                   w_gate=Leaf((E, d, f)), w_up=Leaf((E, d, f)),
                   w_down=Leaf((E, f, d)))
        if e.num_shared:
            fs = e.num_shared * f
            out.update(shared_wg=Leaf((d, fs), lora="wg"),
                       shared_wu=Leaf((d, fs), lora="wu"),
                       shared_wd=Leaf((fs, d), lora="wd"))
    else:
        f = cfg.d_ff
        out.update(wg=Leaf((d, f), lora="wg"), wu=Leaf((d, f), lora="wu"),
                   wd=Leaf((f, d), lora="wd"))
    return out


def jax_key(cfg: ModelConfig, li: int, name: str) -> str:
    """The JAX package's path of layer ``li``'s leaf ``name``, periods axis
    dropped (``blocks/1/shared/wg``)."""
    return f"blocks/{li % len(cfg.pattern)}/{SHARED.get(name, name)}"


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat path -> shape in the JAX package's layout (periods axis first),
    the keys ``repro.checkpoint.io.save_pytree`` writes."""
    out = {"embed": (cfg.vocab, cfg.d_model)}
    for pos in range(len(cfg.pattern)):
        for k, leaf in layer_shapes(cfg, pos).items():
            out[jax_key(cfg, pos, k)] = (cfg.n_periods, *leaf.shape)
    out["final_norm"] = (cfg.d_model,)
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.d_model, cfg.vocab)
    return out


def init_leaf(leaf: Leaf, gen: torch.Generator, device, dtype
              ) -> torch.Tensor:
    if leaf.init == "ones":
        return torch.ones(leaf.shape, device=device, dtype=dtype)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, device=device, dtype=dtype)
    shape = leaf.shape
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = min(leaf.scale, fan_in ** -0.5)
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return t.mul_(std)


def top_leaves(cfg: ModelConfig) -> Dict[str, Leaf]:
    """The leaves outside the blocks (``final_norm`` is made apart)."""
    out = {"embed": Leaf((cfg.vocab, cfg.d_model))}
    if not cfg.tie_embeddings:
        out["lm_head"] = Leaf((cfg.d_model, cfg.vocab))
    return out


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, dtype=None, seed: int = 0) -> Dict:
    """Random parameters, normal(0, min(scale, fan_in^-1/2)) as the JAX
    schema draws them (from a torch generator, so not the same numbers: tests
    that need equal weights cross them over with the bridge).  Runs on
    ``cuda`` unless ``device="cpu"`` is passed."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype, cfg.dtype)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    top = top_leaves(cfg)
    params = {"embed": init_leaf(top["embed"], gen, dev, dt),
              "layers": [{k: init_leaf(leaf, gen, dev, dt)
                          for k, leaf in layer_shapes(cfg, li).items()}
                         for li in range(cfg.n_layers)],
              "final_norm": torch.ones(cfg.d_model, device=dev, dtype=dt)}
    if "lm_head" in top:
        params["lm_head"] = init_leaf(top["lm_head"], gen, dev, dt)
    return params


@dataclasses.dataclass(frozen=True)
class LoraTarget:
    d_in: int
    d_out: int


def lora_targets(cfg: ModelConfig, target_names: Tuple[str, ...]
                 ) -> List[Dict[str, LoraTarget]]:
    """Per-layer LoRA targets, one dict per layer: every eligible leaf whose
    key name (``wg`` for ``shared_wg``, as the JAX walker names it) is in
    ``target_names``; the bank holds one entry per layer for each."""
    out = []
    for li in range(cfg.n_layers):
        out.append({k: LoraTarget(*leaf.shape)
                    for k, leaf in layer_shapes(cfg, li).items()
                    if leaf.lora and leaf.lora in target_names})
    return out
