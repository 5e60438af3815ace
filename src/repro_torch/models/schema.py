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
schema draws them) and ``wo`` [h*dv, d].

A Mamba2 layer (``cfg.layer_kind(li % P) == "mamba"``) has the JAX schema's
head-aligned component projections: ``in_z`` / ``in_x`` [d, di] and
``out_proj`` [di, d] (LoRA targets), ``in_bc`` [d, 2*g*ds] and ``in_dt``
[d, nh], the depthwise conv weights ``conv_x`` [K, di] / ``conv_bc`` [K,
2*g*ds] and biases ``conv_bx`` / ``conv_bbc``, ``a_log`` and ``dt_bias``
[nh] (their own deterministic initialisers), ``d_skip`` [nh] and the gated
norm ``mnorm`` [di].  A layer of a model with ``d_ff = 0`` and no MoE there
(``mamba2-1.3b``) has no FFN and no ``ln2``.

A cross-attention layer (``cfg.is_cross_layer(li % P)``: position 4 of each
period of 5 for ``llama-3.2-vision-90b``, every decoder layer for
``whisper-base``) adds after its mixer the JAX schema's ``xln`` [d] (ones),
``xwq`` [d, h*hd] and ``xwo`` [h*hd, d] (LoRA keys ``xwq`` / ``xwo``, which
the default targets leave out), ``xwk`` / ``xwv`` [d, g*hd] (no LoRA) and
the scalar gate ``xgate`` [] (zeros, so a freshly drawn cross layer adds
nothing).  An encoder (``cfg.encoder``) is ``params["encoder"] = {"layers":
[{ln1, wq, wk, wv, wo, ln2, wg, wu, wd} per encoder layer], "final_norm":
[d]}`` (``encoder_shapes``; the JAX package's ``encoder/blocks/<leaf>``
stacked ``[ne, ...]``), with no LoRA.  A sliding window adds no leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device, resolve_dtype
from repro_torch.models.configs import ModelConfig

# a shared expert's leaves: port key -> the JAX package's nested path
SHARED = {"shared_wg": "shared/wg", "shared_wu": "shared/wu",
          "shared_wd": "shared/wd"}


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One per-layer leaf: ``init`` normal | ones | zeros | a_log |
    dt_bias; ``scale`` caps
    the normal's std (min(scale, fan_in^-1/2), as the JAX schema draws);
    ``lora``: an eligible LoRA target, by the key name ``name``."""
    shape: Tuple[int, ...]
    init: str = "normal"
    scale: float = 0.02
    lora: str = ""
    logical: Tuple[Optional[str], ...] = ()


# each leaf's logical axes: the JAX schema's ``P.logical`` without the
# leading ``periods`` / ``enc_layers`` axis (``repro_torch.distributed.
# sharding`` maps them to mesh axes); a leaf name means the same axes in
# every family
LOGICAL: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("vocab", "embed"), "lm_head": ("embed", "vocab"),
    "final_norm": (None,),
    "ln1": (None,), "ln2": (None,), "xln": (None,),
    "wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"),
    "bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",),
    "wdkv": ("embed", None), "wuk": (None, "heads_sep", None),
    "wuv": (None, "heads_sep", None),
    "xwq": ("embed", "heads"), "xwk": ("embed", "kv_heads"),
    "xwv": ("embed", "kv_heads"), "xwo": ("heads", "embed"), "xgate": (),
    "in_z": ("embed", "ssm"), "in_x": ("embed", "ssm"),
    "in_bc": ("embed", None), "in_dt": ("embed", "ssm_heads"),
    "conv_x": (None, "ssm"), "conv_bx": ("ssm",), "conv_bc": (None, None),
    "conv_bbc": (None,), "a_log": ("ssm_heads",), "d_skip": ("ssm_heads",),
    "dt_bias": ("ssm_heads",), "mnorm": ("ssm",),
    "out_proj": ("ssm", "embed"),
    "router": ("embed", "experts"), "w_gate": ("experts", "embed", "ffn"),
    "w_up": ("experts", "embed", "ffn"), "w_down": ("experts", "ffn", "embed"),
    "wg": ("embed", "ffn"), "wu": ("embed", "ffn"), "wd": ("ffn", "embed"),
    "shared_wg": ("embed", "ffn"), "shared_wu": ("embed", "ffn"),
    "shared_wd": ("ffn", "embed"),
}


def _logical(leaves: Dict[str, Leaf]) -> Dict[str, Leaf]:
    """``leaves`` with each one's logical axes from ``LOGICAL``."""
    out = {}
    for k, leaf in leaves.items():
        axes = LOGICAL[k]
        assert len(axes) == len(leaf.shape), (k, leaf.shape, axes)
        out[k] = dataclasses.replace(leaf, logical=axes)
    return out


def check_supported(cfg: ModelConfig) -> None:
    """GQA or MLA attention and Mamba2 mixers with dense or MoE FFNs (or
    none): any block pattern of ``"attn"`` and ``"mamba"`` positions, the
    latter with ``cfg.ssm``; cross-attention layers, an encoder and a
    sliding window (``cfg.sliding_window > 0``, on the self-attention of
    every family) too."""
    kinds = set(cfg.pattern)
    if (not kinds <= {"attn", "mamba"}
            or ("mamba" in kinds and cfg.ssm is None)):
        raise NotImplementedError(
            f"{cfg.name}: the port covers GQA, MLA and Mamba2 mixers with "
            "dense or MoE FFNs, cross-attention, encoders and sliding "
            f"windows; not the block pattern {cfg.pattern}")


def cross_len(cfg: ModelConfig) -> int:
    """F, the cross source's length: the encoder's frames or the VLM's
    image tokens."""
    return cfg.encoder.n_frames if cfg.encoder else cfg.n_img_tokens


def is_moe(cfg: ModelConfig, li: int) -> bool:
    """Whether layer ``li``'s FFN is a mixture of experts."""
    return cfg.is_moe_layer(li % len(cfg.pattern))


def _mamba_leaves(cfg: ModelConfig) -> Dict[str, Leaf]:
    """The Mamba2 mixer's leaves (the JAX ``_mamba_block``), after
    ``ln1``."""
    d, s = cfg.d_model, cfg.ssm
    di, nh = cfg.d_inner, cfg.n_ssm_heads
    gds = s.n_groups * s.d_state
    return dict(in_z=Leaf((d, di), lora="in_z"),
                in_x=Leaf((d, di), lora="in_x"),
                in_bc=Leaf((d, 2 * gds)), in_dt=Leaf((d, nh)),
                conv_x=Leaf((s.conv_width, di)),
                conv_bx=Leaf((di,), "zeros"),
                conv_bc=Leaf((s.conv_width, 2 * gds)),
                conv_bbc=Leaf((2 * gds,), "zeros"),
                a_log=Leaf((nh,), "a_log"), d_skip=Leaf((nh,), "ones"),
                dt_bias=Leaf((nh,), "dt_bias"), mnorm=Leaf((di,), "ones"),
                out_proj=Leaf((di, d), lora="out_proj"))


def layer_shapes(cfg: ModelConfig, li: int = 0) -> Dict[str, Leaf]:
    """Layer ``li``'s leaves, in the JAX schema's order: the mixer of its
    kind (``cfg.layer_kind(li % P)``), the cross-attention sublayer on a
    cross layer, then its FFN if it has one."""
    check_supported(cfg)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = {"ln1": Leaf((d,), "ones")}
    if cfg.layer_kind(li % len(cfg.pattern)) == "mamba":
        out.update(_mamba_leaves(cfg))
    elif cfg.mla is not None:
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
        if cfg.qkv_bias:
            out.update(bq=Leaf((h * hd,), "zeros"),
                       bk=Leaf((kv * hd,), "zeros"),
                       bv=Leaf((kv * hd,), "zeros"))
    if cfg.is_cross_layer(li % len(cfg.pattern)):
        out.update(xln=Leaf((d,), "ones"),
                   xwq=Leaf((d, h * hd), lora="xwq"),
                   xwk=Leaf((d, kv * hd)), xwv=Leaf((d, kv * hd)),
                   xwo=Leaf((h * hd, d), lora="xwo"),
                   xgate=Leaf((), "zeros"))
    if is_moe(cfg, li):
        e = cfg.moe
        E, f = e.num_experts, e.d_ff_expert
        out["ln2"] = Leaf((d,), "ones")
        out.update(router=Leaf((d, E), scale=0.006),
                   w_gate=Leaf((E, d, f)), w_up=Leaf((E, d, f)),
                   w_down=Leaf((E, f, d)))
        if e.num_shared:
            fs = e.num_shared * f
            out.update(shared_wg=Leaf((d, fs), lora="wg"),
                       shared_wu=Leaf((d, fs), lora="wu"),
                       shared_wd=Leaf((fs, d), lora="wd"))
    elif cfg.d_ff > 0:
        f = cfg.d_ff
        out["ln2"] = Leaf((d,), "ones")
        out.update(wg=Leaf((d, f), lora="wg"), wu=Leaf((d, f), lora="wu"),
                   wd=Leaf((f, d), lora="wd"))
    return _logical(out)


def encoder_shapes(cfg: ModelConfig) -> Dict[str, Leaf]:
    """One encoder layer's leaves (the JAX schema's ``encoder/blocks``, the
    ``[ne]`` axis dropped): plain products, no LoRA."""
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.d_ff
    return _logical(dict(ln1=Leaf((d,), "ones"), wq=Leaf((d, h * hd)),
                         wk=Leaf((d, kv * hd)), wv=Leaf((d, kv * hd)),
                         wo=Leaf((h * hd, d)), ln2=Leaf((d,), "ones"),
                         wg=Leaf((d, f)), wu=Leaf((d, f)),
                         wd=Leaf((f, d))))


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
    if cfg.encoder is not None:
        for k, leaf in encoder_shapes(cfg).items():
            out[f"encoder/blocks/{k}"] = (cfg.encoder.n_layers, *leaf.shape)
        out["encoder/final_norm"] = (cfg.d_model,)
    return out


def init_leaf(leaf: Leaf, gen: torch.Generator, device, dtype
              ) -> torch.Tensor:
    if leaf.init == "ones":
        return torch.ones(leaf.shape, device=device, dtype=dtype)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, device=device, dtype=dtype)
    if leaf.init == "a_log":
        # A = -exp(a_log) spans [-16, -1] over the heads
        nh = leaf.shape[-1]
        base = torch.log(torch.linspace(1.0, 16.0, nh, device=device))
        return base.expand(leaf.shape).to(dtype).contiguous()
    if leaf.init == "dt_bias":
        # inverse softplus of dt spread log-uniformly over [1e-3, 0.1]
        nh = leaf.shape[-1]
        dt = torch.exp(torch.linspace(math.log(1e-3), math.log(0.1), nh,
                                      device=device))
        base = torch.log(torch.expm1(dt))
        return base.expand(leaf.shape).to(dtype).contiguous()
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
    return _logical(out)


def param_logical_axes(cfg: ModelConfig) -> Dict:
    """The logical axes of every leaf, in the params' tree (the JAX
    ``param_logical_axes`` in the port's per-layer layout, its periods
    axis dropped)."""
    out = {k: leaf.logical for k, leaf in top_leaves(cfg).items()}
    out["layers"] = [{k: leaf.logical
                      for k, leaf in layer_shapes(cfg, li).items()}
                     for li in range(cfg.n_layers)]
    out["final_norm"] = LOGICAL["final_norm"]
    if cfg.encoder is not None:
        out["encoder"] = {
            "layers": [{k: leaf.logical
                        for k, leaf in encoder_shapes(cfg).items()}
                       for _ in range(cfg.encoder.n_layers)],
            "final_norm": LOGICAL["final_norm"]}
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
    if cfg.encoder is not None:
        params["encoder"] = {
            "layers": [{k: init_leaf(leaf, gen, dev, dt)
                        for k, leaf in encoder_shapes(cfg).items()}
                       for _ in range(cfg.encoder.n_layers)],
            "final_norm": torch.ones(cfg.d_model, device=dev, dtype=dt)}
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
