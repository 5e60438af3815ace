"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 with MoE [arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.  Each 8-layer period
contains 1 attention + 7 Mamba layers; MoE (16 experts, top-2) every other
layer, dense FFN on the rest.
"""
from repro_torch.models.configs import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64, n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    rope_theta=10000.0,
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576, num_shared=0,
                  every=2, capacity_factor=1.25),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=128, conv_width=4),
    source="Jamba-1.5 [arXiv:2403.19887]",
)

REDUCED = CONFIG.replace(
    name="jamba-reduced", n_layers=4, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512,
    block_pattern=("mamba", "attn", "mamba", "mamba"),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=512, num_shared=0,
                  every=2, capacity_factor=1.5),
    ssm=SSMConfig(d_state=16, head_dim=32, expand=2, chunk=16, conv_width=4),
)
