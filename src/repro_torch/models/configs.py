"""Model configuration schema for all supported architecture families.

A single ``ModelConfig`` describes dense GQA transformers, MLA (DeepSeek-V2),
MoE, Mamba2/SSD, hybrid (Jamba), encoder-decoder (Whisper backbone) and
VLM cross-attention decoders.  Layers are organised as ``n_periods`` repeats
of ``block_pattern`` so the model can be ``lax.scan``-ed over periods with an
O(1)-size HLO body regardless of depth.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int                 # routed experts
    top_k: int
    d_ff_expert: int                 # per-expert FFN hidden size
    num_shared: int = 0              # always-on shared experts
    every: int = 1                   # MoE on layers with (idx % every == every-1); others dense
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512          # compressed KV latent width (cached)
    qk_rope_dim: int = 64            # rope sub-head width (shared across heads)
    qk_nope_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128                 # SSD chunk length (train/prefill)
    conv_width: int = 4
    n_groups: int = 1


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder backbone.  The mel+conv frontend is a STUB:
    ``input_specs`` supplies precomputed frame embeddings [B, n_frames, d_model]."""
    n_layers: int = 6
    n_frames: int = 1500


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    block_pattern: Tuple[str, ...] = ("attn",)   # cycled; entries: attn | mamba
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    cross_attn_every: int = 0        # >0: cross-attn on layers with idx % every == every-1
    n_img_tokens: int = 1600         # VLM stub: vision tokens per image
    encoder: Optional[EncoderConfig] = None
    sliding_window: int = 0          # 0 = full attention; >0 = window size (decode variant)
    dtype: str = "float32"           # activation/param dtype ("bfloat16" for dry-run)
    # citation / provenance for assigned-architecture configs
    source: str = ""

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def pattern(self) -> Tuple[str, ...]:
        return self.block_pattern

    @property
    def n_periods(self) -> int:
        p = len(self.block_pattern)
        assert self.n_layers % p == 0, (self.name, self.n_layers, p)
        return self.n_layers // p

    def layer_kind(self, pos: int) -> str:
        """Block kind at pattern position ``pos`` (same for every period)."""
        return self.block_pattern[pos]

    def is_moe_layer(self, pos: int) -> bool:
        if self.moe is None:
            return False
        return (pos % self.moe.every) == (self.moe.every - 1)

    def has_ffn(self, pos: int) -> bool:
        """A dense FFN / MoE follows the mixer at this pattern position."""
        if self.is_moe_layer(pos):
            return True
        return self.d_ff > 0

    def is_cross_layer(self, pos: int) -> bool:
        """Cross-attention (VLM / enc-dec decoder) at this pattern position."""
        if self.encoder is not None:
            return self.block_pattern[pos] == "attn"   # every decoder layer cross-attends
        if self.cross_attn_every <= 0:
            return False
        return (pos % self.cross_attn_every) == (self.cross_attn_every - 1)

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.d_inner // self.ssm.head_dim

    def validate(self) -> None:
        assert self.arch_type in ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
        assert self.n_heads % self.n_kv_heads == 0
        if self.cross_attn_every:
            assert len(self.block_pattern) % self.cross_attn_every == 0 or \
                self.cross_attn_every % len(self.block_pattern) == 0
        _ = self.n_periods

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Rough parameter counts for roofline MODEL_FLOPS = 6*N*D.
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.hd
        n = self.vocab * d  # embed
        if not self.tie_embeddings:
            n += d * self.vocab
        for pos in range(len(self.block_pattern)):
            kind = self.block_pattern[pos]
            per = 0
            if kind == "attn":
                if self.mla is not None:
                    m = self.mla
                    qd = m.qk_nope_dim + m.qk_rope_dim
                    per += d * self.n_heads * qd                       # W_q
                    per += d * (m.kv_lora_rank + m.qk_rope_dim)        # down-proj
                    per += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                    per += self.n_heads * m.v_head_dim * d             # W_o
                else:
                    per += d * self.n_heads * hd
                    per += 2 * d * self.n_kv_heads * hd
                    per += self.n_heads * hd * d
                if self.is_cross_layer(pos):
                    per += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                        + self.n_heads * hd * d
            elif kind == "mamba":
                s = self.ssm
                di = self.d_inner
                zxbcdt = 2 * di + 2 * s.n_groups * s.d_state + self.n_ssm_heads
                per += d * zxbcdt + di * d
            # FFN
            if self.is_moe_layer(pos):
                e = self.moe
                ff_all = 3 * d * e.d_ff_expert
                routed = e.num_experts * ff_all
                shared = e.num_shared * 3 * d * e.d_ff_expert if e.num_shared else 0
                per += d * e.num_experts  # router
                if active_only:
                    per += e.top_k * ff_all + shared
                else:
                    per += routed + shared
            elif self.d_ff > 0:
                per += 3 * d * self.d_ff
            n += per * self.n_periods
        if self.encoder is not None:
            enc_per = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d + 3 * d * self.d_ff
            n += enc_per * self.encoder.n_layers
        return n
