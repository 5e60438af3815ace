"""whisper-base — encoder-decoder audio backbone [arXiv:2212.04356].

6L (enc) + 6L (dec) d_model=512 8H d_ff=2048 vocab=51865.  The mel/conv
frontend is a stub, as in the JAX package: a request carries precomputed
frame embeddings ``aux_embed`` [1500, 512]; the transformer backbone
(bidirectional encoder + causal decoder with cross-attention) is the model.
"""
from repro_torch.models.configs import ModelConfig, EncoderConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    n_layers=6,                    # decoder layers; encoder layers in EncoderConfig
    d_model=512,
    n_heads=8, n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    rope_theta=10000.0,
    encoder=EncoderConfig(n_layers=6, n_frames=1500),
    source="Whisper [arXiv:2212.04356]",
)

REDUCED = CONFIG.replace(
    name="whisper-reduced", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512, encoder=EncoderConfig(n_layers=2, n_frames=32),
)
