"""deepseek-v2-236b — MLA + MoE [arXiv:2405.04434].

60L d_model=5120 128H (MLA kv_lora=512) d_ff_expert=1536 vocab=102400,
MoE: 2 shared + 160 routed, top-6.
"""
from repro_torch.models.configs import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128, n_kv_heads=128,
    head_dim=128,
    d_ff=0,                       # all FFNs are MoE
    vocab=102400,
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536, num_shared=2,
                  every=1, capacity_factor=1.25),
    mla=MLAConfig(kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128,
                  v_head_dim=128),
    source="DeepSeek-V2 [arXiv:2405.04434]",
)

REDUCED = CONFIG.replace(
    name="dsv2-reduced", n_layers=2, d_model=256, n_heads=8, n_kv_heads=8,
    head_dim=32, vocab=512,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256, num_shared=1,
                  every=1, capacity_factor=1.5),
    mla=MLAConfig(kv_lora_rank=64, qk_rope_dim=16, qk_nope_dim=32,
                  v_head_dim=32),
)
