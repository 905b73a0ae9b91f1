"""deepseek-v3-671b [moe] — MLA + 256 routed experts top-8, arXiv:2412.19437.

61L d_model=7168 128H MLA (q_lora 1536, kv_lora 512, nope 128, rope 64,
v 128), 1 shared + 256 routed top-8, expert d_ff=2048, vocab=129280.
(MTP head noted as out of scope in DESIGN.md.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=2048,
    vocab_size=129_280, head_dim=192,
    layer_pattern=("attn",), moe_pattern=(True,),
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=256, top_k=8, n_shared_experts=1, moe_d_ff=2048,
)
