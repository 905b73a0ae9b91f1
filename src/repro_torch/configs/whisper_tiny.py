"""whisper-tiny [audio] — encoder-decoder, arXiv:2212.04356.

4L enc + 4L dec, d_model=384 6H (kv=6) d_ff=1536 vocab=51865.  The conv
audio frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (B, 1500, 384).  RoPE stands in for whisper's
learned absolute positions (noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab_size=51_865, head_dim=64,
    layer_pattern=("attn_cross",),
    mlp_act="gelu",
    encoder_layers=4, n_frontend_tokens=1500,
)
