"""command-r-35b — dense GQA, no bias [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    arch_type="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64, n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    rope_theta=8000000.0,
    tie_embeddings=True,
    source="Command-R [hf:CohereForAI/c4ai-command-r-v01]",
)

REDUCED = CONFIG.replace(
    name="commandr-reduced", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512,
)
