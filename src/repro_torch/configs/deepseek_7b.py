"""deepseek-7b — dense llama-arch [arXiv:2401.02954].

30L d_model=4096 32H (GQA kv=32, i.e. MHA) d_ff=11008 vocab=102400.
"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    arch_type="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32, n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    rope_theta=10000.0,
    source="DeepSeek LLM [arXiv:2401.02954]",
)

REDUCED = CONFIG.replace(
    name="deepseek7b-reduced", n_layers=2, d_model=256, n_heads=8, n_kv_heads=8,
    d_ff=512, vocab=512,
)
