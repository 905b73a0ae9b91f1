"""mamba2-780m [ssm] — SSD (state-space duality), arXiv:2405.21060.

48L d_model=1536, attention-free (d_ff=0: the mamba block is the whole
layer), vocab=50280, ssm_state=128, head_dim 64, expand 2 (d_inner 3072).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=50_280,
    layer_pattern=("mamba",),
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    ssm_chunk=256, ssm_ngroups=1,
)
