"""qwen1.5-110b — dense, QKV bias [hf:Qwen/Qwen1.5-0.5B family scaling].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    arch_type="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64, n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    source="Qwen1.5 [hf:Qwen/Qwen1.5-0.5B]",
)

REDUCED = CONFIG.replace(
    name="qwen1.5-reduced", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512,
)
