"""mamba2-1.3b — SSD (state-space duality), attention-free [arXiv:2405.21060].

48L d_model=2048, d_ff=0 (no MLP; the Mamba2 block is the whole layer),
vocab=50280, ssm_state=128.
"""
from repro_torch.models.configs import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1, n_kv_heads=1,          # unused (attention-free)
    d_ff=0,
    vocab=50280,
    block_pattern=("mamba",),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=128, conv_width=4),
    tie_embeddings=True,
    source="SSD / Mamba2 [arXiv:2405.21060]",
)

REDUCED = CONFIG.replace(
    name="mamba2-reduced", n_layers=2, d_model=256, vocab=512,
    ssm=SSMConfig(d_state=16, head_dim=32, expand=2, chunk=16, conv_width=4),
)
