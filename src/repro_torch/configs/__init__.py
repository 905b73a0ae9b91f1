"""Registry of the 10 assigned architectures + reduced smoke variants
(port of ``repro/configs/__init__.py``)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import shapes as shapes_lib  # noqa: F401
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable  # noqa: F401

from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.granite_20b import CONFIG as _granite
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2
from repro_torch.configs.internlm2_20b import CONFIG as _internlm2
from repro_torch.configs.gemma3_27b import CONFIG as _gemma3
from repro_torch.configs.whisper_tiny import CONFIG as _whisper
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.deepseek_v3_671b import CONFIG as _deepseek
from repro_torch.configs.llama_3_2_vision_11b import CONFIG as _llama_v
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _jamba

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in [
    _mamba2, _granite, _starcoder2, _internlm2, _gemma3, _whisper,
    _kimi, _deepseek, _llama_v, _jamba,
]}


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving reduced config for CPU smoke tests: same layer
    pattern / block kinds, tiny widths, one period + remainder."""
    kv = max(1, (4 * cfg.n_kv_heads) // max(cfg.n_heads, 1)) \
        if cfg.n_heads > 1 else 1
    return cfg.replace(
        n_layers=cfg.period + cfg.n_rem,
        d_model=64,
        n_heads=4 if cfg.n_heads > 1 else 1,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        window=16,
        q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16,
        n_experts=8 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        ssm_state=16, ssm_head_dim=8, ssm_expand=2, ssm_chunk=16,
        encoder_layers=2 if cfg.encoder_layers else 0,
        n_frontend_tokens=24 if cfg.n_frontend_tokens else 0,
        param_dtype="float32", compute_dtype="float32",
    )


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    cfg = ARCHS[name]
    return reduce_config(cfg) if reduced else cfg
