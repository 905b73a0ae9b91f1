"""llama-3.2-vision-11b [vlm] — cross-attn image layers.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; every 5th layer is
a gated cross-attention block over precomputed image-patch embeddings
(STUB frontend: (B, 1601, 4096) per the assignment).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14_336,
    vocab_size=128_256, head_dim=128,
    layer_pattern=("attn", "attn", "attn", "attn", "cross_attn"),
    rope_theta=500_000.0,
    n_frontend_tokens=1601,
)
