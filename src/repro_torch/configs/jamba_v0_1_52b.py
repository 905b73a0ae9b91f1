"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7, MoE, arXiv:2403.19887.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536; period of 8 layers
with attention at offset 4 (1:7), MoE (16 experts top-2) on odd offsets.
SSM blocks use the mamba-2 SSD form (hardware adaptation noted in
DESIGN.md; jamba v0.1 itself uses mamba-1 with d_state 16).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14_336,
    vocab_size=65_536, head_dim=128,
    layer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe_pattern=(False, True, False, True, False, True, False, True),
    n_experts=16, top_k=2, n_shared_experts=0, moe_d_ff=14_336,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2,
)
