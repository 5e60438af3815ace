"""llama4-maverick-400b-a17b — MoE 128e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E family].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.  MoE (128 routed
top-1 + 1 shared expert) interleaved every other layer, dense FFN otherwise —
matching Maverick's interleaved MoE giving ~400B total / ~17B active params.
"""
from repro_torch.models.configs import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40, n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    rope_theta=500000.0,
    block_pattern=("attn", "attn"),
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192, num_shared=1,
                  every=2, capacity_factor=1.25),
    source="Llama 4 Maverick [hf:meta-llama/Llama-4-Scout-17B-16E]",
)

REDUCED = CONFIG.replace(
    name="llama4-reduced", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512,
    moe=MoEConfig(num_experts=4, top_k=1, d_ff_expert=512, num_shared=1,
                  every=2, capacity_factor=1.5),
)
