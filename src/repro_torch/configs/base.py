"""Unified architecture config covering all 10 assigned families (port of
``repro/configs/base.py``; ``pdtype`` / ``cdtype`` are torch dtypes).

A model is a repeated *period* of layer kinds (``layer_pattern``) plus a
remainder (``n_layers = len(pattern) * n_periods + n_rem``; the remainder
takes the first ``n_rem`` kinds of the pattern).  Kinds:

  * ``attn``        — global causal self-attention (GQA or MLA)
  * ``attn_local``  — sliding-window causal self-attention (``window``)
  * ``mamba``       — mamba-2 SSD block (attention-free)
  * ``cross_attn``  — cross-attention block over frontend embeddings (VLM)
  * ``attn_cross``  — whisper's decoder block: self- then cross-attention

``moe_pattern`` marks which period positions use a mixture-of-experts FFN.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | ssm | moe | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    layer_pattern: Tuple[str, ...] = ("attn",)
    moe_pattern: Tuple[bool, ...] = ()
    window: int = 1024
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    mlp_act: str = "silu"             # gated silu (llama-style) | gelu
    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01      # Switch-style load-balance loss weight
    # --- SSM (mamba-2) ---
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    # --- encoder-decoder / frontend stubs ---
    encoder_layers: int = 0           # whisper encoder depth
    n_frontend_tokens: int = 0        # audio frames / image tokens (stub)
    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self):
        assert self.n_layers >= 1
        assert len(self.layer_pattern) >= 1
        if self.moe_pattern:
            assert len(self.moe_pattern) == len(self.layer_pattern)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def n_rem(self) -> int:
        return self.n_layers % self.period

    @property
    def d_inner(self) -> int:          # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_moe(self) -> bool:
        return any(self.moe_pattern)

    @property
    def pdtype(self):
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self):
        return _DTYPES[self.compute_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def active_param_count_estimate(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only).
        Used for MODEL_FLOPS = 6 * N_active * tokens in the roofline."""
        if not self.has_moe:
            return self.param_count_estimate()
        dense = dataclasses.replace(
            self, moe_pattern=(False,) * self.period,
            d_ff=0).param_count_estimate()
        # Add per-layer active expert + shared + router params.
        moe = list(self.moe_pattern)
        n_moe_layers = sum(moe) * self.n_periods + sum(moe[: self.n_rem])
        per_layer = ((self.top_k + self.n_shared_experts) * 3
                     * self.d_model * self.moe_d_ff
                     + self.d_model * self.n_experts)
        # Non-MoE layers keep their dense FFN.
        n_mats = 3 if self.mlp_act == "silu" else 2
        n_dense_layers = (self.n_layers - n_moe_layers)
        dense_ffn = (n_dense_layers * n_mats * self.d_model * self.d_ff
                     if self.d_ff else 0)
        return int(dense + n_moe_layers * per_layer + dense_ffn)

    # Rough parameter count (reported in the dry-run / roofline tables).
    def param_count_estimate(self) -> int:
        d, v = self.d_model, self.vocab_size
        total = 2 * v * d  # embed + head
        kinds = list(self.layer_pattern) * self.n_periods \
            + list(self.layer_pattern[: self.n_rem])
        moe = list(self.moe_pattern or (False,) * self.period)
        moe_flags = moe * self.n_periods + moe[: self.n_rem]
        hd = self.resolved_head_dim
        for kind, is_moe in zip(kinds, moe_flags):
            if kind == "mamba":
                di, g, ns = self.d_inner, self.ssm_ngroups, self.ssm_state
                nh = self.ssm_heads
                total += d * (2 * di + 2 * g * ns + nh)      # in_proj
                total += di * d                               # out_proj
                total += (di + 2 * g * ns) * self.ssm_conv_width
                total += 3 * nh + di                          # A, D, dt_bias, norm
            elif self.use_mla and kind == "attn":
                r_q, r_kv = self.q_lora_rank, self.kv_lora_rank
                qk = self.qk_nope_dim + self.qk_rope_dim
                total += d * r_q + r_q * self.n_heads * qk
                total += d * (r_kv + self.qk_rope_dim)
                total += r_kv * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                total += self.n_heads * self.v_head_dim * d
            elif kind in ("attn", "attn_local", "cross_attn"):
                total += d * self.n_heads * hd                # q
                total += 2 * d * self.n_kv_heads * hd         # k, v
                total += self.n_heads * hd * d                # o
            n_mats = 3 if self.mlp_act == "silu" else 2   # gated vs plain
            if is_moe:
                total += self.n_experts * 3 * d * self.moe_d_ff
                total += self.n_shared_experts * 3 * d * self.moe_d_ff
                total += d * self.n_experts                   # router
            elif self.d_ff > 0:
                total += n_mats * d * self.d_ff
            total += 2 * d                                    # norms
        if self.encoder_layers:
            enc = self.encoder_layers * (4 * d * self.n_heads * hd
                                         + 3 * d * self.d_ff + 2 * d)
            # decoder cross-attn blocks already counted via layer_pattern
            total += enc
        return int(total)
