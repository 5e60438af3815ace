"""llama3-8b — the paper's own base model [arXiv:2407.21783].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.  Used by the
paper-claim benchmarks (Tables 2-8, Figures 2-6) in reduced form.
"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32, n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=500000.0,
    source="Llama 3 [arXiv:2407.21783] (paper base model)",
)

REDUCED = CONFIG.replace(
    name="llama3-reduced", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512,
)
