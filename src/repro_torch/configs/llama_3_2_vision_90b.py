"""llama-3.2-vision-90b — VLM with cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision family].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  Every 5th decoder
layer cross-attends to vision-patch embeddings.  The ViT/projector frontend is
a stub, as in the JAX package: a request carries precomputed patch
embeddings ``aux_embed`` [n_img_tokens, d_model].
"""
from repro_torch.models.configs import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64, n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    rope_theta=500000.0,
    block_pattern=("attn",) * 5,
    cross_attn_every=5,
    n_img_tokens=1600,
    source="Llama 3.2 Vision [hf:meta-llama/Llama-3.2-11B-Vision]",
)

REDUCED = CONFIG.replace(
    name="llama32v-reduced", n_layers=5, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512, n_img_tokens=16,
)
