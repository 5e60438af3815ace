"""Analytical per-step cost model: FLOPs, HBM traffic, collective bytes.

Why analytical: the port runs eagerly, one PyTorch operation and one kernel
launch after another, so there is no compiled program whose cost could be
read back (the JAX package's XLA ``cost_analysis`` also counts each
while-loop body once, not times its trip count, which is why it keeps this
model beside the compiled numbers).  These napkin-math numbers are exact for
the matmul-dominated flows, depend only on the config, the input shape, the
mesh and the sharding strategy (``fsdp_tp`` baseline; ``tp`` keeps whole
weights per device), and are the least work a step must do: divided by the
card's peak rate and memory rate (``repro_torch.roofline.analysis``) they
give the bound a measured tick is held to.

All quantities are PER DEVICE PER STEP.  The LoRA bytes of the gradient
all-reduce are counted through the port's own per-layer LoRA targets
(``repro_torch.models.schema.lora_targets``): one ``(d_in + d_out) * r``
per slot, target and layer, which is what the JAX package's stacked leaves
count over their periods axis.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.lora import LoRAConfig
from repro_torch.models.configs import ModelConfig
from repro_torch.models.schema import lora_targets


@dataclasses.dataclass
class StepCost:
    flops: float = 0.0               # per-device
    hbm_bytes: float = 0.0           # per-device
    coll_bytes: float = 0.0          # per-device (sent)
    detail: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, key: str, flops=0.0, hbm=0.0, coll=0.0):
        self.flops += flops
        self.hbm_bytes += hbm
        self.coll_bytes += coll
        if flops:
            self.detail[f"flops/{key}"] = self.detail.get(f"flops/{key}", 0.0) + flops
        if hbm:
            self.detail[f"hbm/{key}"] = self.detail.get(f"hbm/{key}", 0.0) + hbm
        if coll:
            self.detail[f"coll/{key}"] = self.detail.get(f"coll/{key}", 0.0) + coll


BYTES = 2            # bf16


def _tp_shardable_heads(cfg: ModelConfig, tp: int) -> bool:
    return cfg.n_heads % tp == 0


def step_cost(cfg: ModelConfig, kind: str, seq_len: int, global_batch: int,
              *, dp: int, tp: int, strategy: str = "fsdp_tp",
              attn_chunk: int = 1024) -> StepCost:
    """kind: train | prefill | decode.  dp = product of batch axes."""
    c = StepCost()
    d, hd, V = cfg.d_model, cfg.hd, cfg.vocab
    P = cfg.n_periods
    heads_tp = tp if _tp_shardable_heads(cfg, tp) else 1
    ffn_tp = tp
    # tokens processed this step
    if kind == "decode":
        tokens = global_batch
        s_kv = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    else:
        tokens = global_batch * seq_len
        s_kv = seq_len
    t_loc = tokens / min(dp, global_batch)      # batch may not shard fully
    if global_batch % dp != 0:
        t_loc = tokens                           # replicated batch (long_500k)
    # training backward ~2x fwd matmuls (dX only; base dW frozen) + remat fwd
    train_mult = 3.0 if kind == "train" else 1.0

    # ---------------- per pattern position ----------------
    for pos, kindp in enumerate(cfg.pattern):
        if kindp == "attn":
            if cfg.mla is not None:
                m = cfg.mla
                qd = m.qk_nope_dim + m.qk_rope_dim
                w_attn = d * cfg.n_heads * qd + d * (m.kv_lora_rank + m.qk_rope_dim) \
                    + cfg.n_heads * m.v_head_dim * d
                w_absorb = m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)
                c.add("mla_proj", flops=2 * t_loc * w_attn / heads_tp * train_mult * P)
                if kind == "decode":
                    # absorbed: q_lat prep + scores/out against latent
                    f = t_loc * cfg.n_heads * (2 * m.qk_nope_dim * m.kv_lora_rank * 2
                                               + 2 * s_kv * (m.kv_lora_rank * 2 + m.qk_rope_dim))
                    c.add("mla_attn", flops=f / heads_tp * P)
                else:
                    # chunked: expand K/V per block + scores
                    f = 2 * t_loc * cfg.n_heads * s_kv * (m.qk_nope_dim + m.qk_rope_dim + m.v_head_dim) \
                        + 2 * (s_kv / max(dp, 1)) * m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim) * (tokens / t_loc)
                    c.add("mla_attn", flops=f / heads_tp * train_mult * P)
            else:
                w_attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
                    + cfg.n_heads * hd * d
                c.add("attn_proj", flops=2 * t_loc * w_attn / heads_tp * train_mult * P)
                win = cfg.sliding_window or 0
                eff_kv = min(s_kv, win) if win else s_kv
                f = 2 * 2 * t_loc * cfg.n_heads * hd * eff_kv
                c.add("attn_sdpa", flops=f / heads_tp * train_mult * P)
            if cfg.is_cross_layer(pos):
                n_x = cfg.encoder.n_frames if cfg.encoder else cfg.n_img_tokens
                w_x = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                c.add("xattn", flops=(2 * t_loc * w_x + 4 * t_loc * cfg.n_heads * hd * n_x)
                      / heads_tp * train_mult * P)
        else:  # mamba (head-parallel TP when head count divides the axis)
            di = cfg.d_inner
            s = cfg.ssm
            gds = s.n_groups * s.d_state
            ssm_tp = tp if cfg.n_ssm_heads % tp == 0 else 1
            w_m = d * (2 * di + 2 * gds + cfg.n_ssm_heads) + di * d
            c.add("ssm_proj", flops=2 * t_loc * w_m / ssm_tp * train_mult * P)
            if kind == "decode":
                f = t_loc * cfg.n_ssm_heads * s.head_dim * s.d_state * 4
            else:
                Q = min(s.chunk, s_kv)
                # intra-chunk (Q^2) + state ingest/emit
                f = 2 * t_loc * cfg.n_ssm_heads * (Q * (s.d_state + s.head_dim)
                                                   + 2 * s.head_dim * s.d_state)
            c.add("ssm_scan", flops=f / ssm_tp * train_mult * P)

        # FFN / MoE
        if cfg.is_moe_layer(pos):
            e = cfg.moe
            w_e = 3 * d * e.d_ff_expert
            c.add("moe_expert", flops=2 * t_loc * e.top_k * e.capacity_factor
                  * w_e / ffn_tp * train_mult * P)
            c.add("moe_router", flops=2 * t_loc * d * e.num_experts * train_mult * P)
            if e.num_shared:
                c.add("moe_shared", flops=2 * t_loc * e.num_shared * w_e / ffn_tp
                      * train_mult * P)
        elif cfg.d_ff > 0:
            c.add("ffn", flops=2 * t_loc * 3 * d * cfg.d_ff / ffn_tp * train_mult * P)

    # encoder (whisper) — runs on prefill/train rows only
    if cfg.encoder is not None and kind != "decode":
        rows_loc = max(global_batch / min(dp, global_batch), 1)
        ft = rows_loc * cfg.encoder.n_frames
        w_enc = (2 + 2 * cfg.n_kv_heads / cfg.n_heads) * d * cfg.n_heads * hd \
            + 3 * d * cfg.d_ff
        c.add("encoder", flops=(2 * ft * w_enc
                                + 4 * ft * cfg.n_heads * hd * cfg.encoder.n_frames)
              * cfg.encoder.n_layers * train_mult)

    # head + embed
    vtp = tp if V % tp == 0 else 1
    if kind == "train":
        c.add("lm_head", flops=2 * t_loc * d * V / vtp * train_mult)
    else:
        rows_loc = max(global_batch / min(dp, global_batch), 1)
        c.add("lm_head", flops=2 * rows_loc * d * V / vtp)

    # ---------------- HBM traffic ----------------
    n_params = cfg.param_count()
    if strategy == "fsdp_tp":
        local_w = n_params * BYTES / tp
        c.add("weights", hbm=2 * local_w)      # AG write + matmul read
        c.add("weights_ag", coll=local_w)      # received bytes per device
    else:
        c.add("weights", hbm=n_params * BYTES / tp)
    act_traffic = 12 * t_loc * d * BYTES * P * (2 if kind == "train" else 1)
    c.add("activations", hbm=act_traffic)
    if kind != "train":
        cache_b = _cache_bytes_local(cfg, global_batch, s_kv, dp, tp)
        c.add("cache", hbm=cache_b * (1.0 if kind == "decode" else 2.0))

    # ---------------- collectives ----------------
    if heads_tp > 1 or ffn_tp > 1:
        # 2 reduce ops per layer on [t_loc, d] activations (TP row-parallel)
        c.add("tp_allreduce", coll=2 * 2 * t_loc * d * BYTES * P
              * (2 if kind == "train" else 1))
    if cfg.moe is not None:
        n_moe_layers = sum(cfg.is_moe_layer(p)
                           for p in range(len(cfg.pattern))) * P
        # the expert dispatch shards tokens over (batch axes x model), so
        # the per-device all-to-all volume is T/chips x k x cf x d each way
        t_moe = tokens / (dp * tp) if tokens % (dp * tp) == 0 else t_loc
        c.add("moe_a2a", coll=2 * t_moe * cfg.moe.top_k
              * cfg.moe.capacity_factor * d * BYTES
              * n_moe_layers * (2 if kind == "train" else 1))
    if kind == "decode" and cfg.mla is None and _has_attn(cfg) \
            and cfg.n_kv_heads % tp != 0:
        # hd-sharded cache -> per-layer partial-score all-reduce (f32 scores)
        rows_loc = max(global_batch / min(dp, global_batch), 1)
        n_attn_layers = sum(1 for k in cfg.pattern if k == "attn") * P
        sc = min(s_kv, cfg.sliding_window) if cfg.sliding_window else s_kv
        c.add("score_allreduce",
              coll=2 * rows_loc * cfg.n_heads * sc * 4 * n_attn_layers)
    if kind == "train":
        # LoRA grad all-reduce over dp (banks are replicated)
        lora_b = _lora_bytes(cfg)
        c.add("grad_allreduce", coll=2 * lora_b)
    return c


def _has_attn(cfg: ModelConfig) -> bool:
    return any(k == "attn" for k in cfg.pattern)


def _cache_bytes_local(cfg: ModelConfig, b: int, s_kv: int, dp: int,
                       tp: int) -> float:
    rows_loc = b / dp if b % dp == 0 else b
    total = 0.0
    for pos, kindp in enumerate(cfg.pattern):
        if kindp == "attn":
            if cfg.mla is not None:
                per = s_kv * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim)
                per_tp = tp if s_kv % tp == 0 else 1
            else:
                per = 2 * s_kv * cfg.n_kv_heads * cfg.hd
                per_tp = tp if (cfg.n_kv_heads % tp == 0 or cfg.hd % tp == 0) else 1
            if cfg.is_cross_layer(pos):
                nx = cfg.encoder.n_frames if cfg.encoder else cfg.n_img_tokens
                per += 2 * nx * cfg.n_kv_heads * cfg.hd
        else:
            s = cfg.ssm
            per = cfg.n_ssm_heads * s.head_dim * s.d_state \
                + (s.conv_width - 1) * (cfg.d_inner + 2 * s.n_groups * s.d_state)
            per_tp = 1
        total += rows_loc * per * BYTES * cfg.n_periods / per_tp
    return total


def _lora_bytes(cfg: ModelConfig, n_slots: int = 4, r: int = 16) -> float:
    # rough: every eligible linear gets (d_in + d_out) * r per slot and layer
    total = sum(n_slots * (t.d_in + t.d_out) * r
                for layer in lora_targets(cfg, LoRAConfig().targets)
                for t in layer.values())
    return total * BYTES
