"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144; sliding window
1024 on local layers.  62 = 10 periods of (5 local + 1 global) + 2 locals.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21_504,
    vocab_size=262_144, head_dim=128,
    layer_pattern=("attn_local",) * 5 + ("attn",),
    window=1024, rope_theta=1_000_000.0,
)
