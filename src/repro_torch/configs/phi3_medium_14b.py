"""phi3-medium-14b — dense, RoPE SwiGLU GQA [arXiv:2404.14219].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40, n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    rope_theta=10000.0,
    source="Phi-3 [arXiv:2404.14219]",
)

REDUCED = CONFIG.replace(
    name="phi3-reduced", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512,
)
