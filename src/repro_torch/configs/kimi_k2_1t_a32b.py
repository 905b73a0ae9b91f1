"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table config).

61L d_model=7168 64H (GQA kv=8) vocab=163840; 384 routed experts top-8 +
1 shared, expert d_ff=2048.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163_840, head_dim=128,
    layer_pattern=("attn",), moe_pattern=(True,),
    n_experts=384, top_k=8, n_shared_experts=1, moe_d_ff=2048,
)
