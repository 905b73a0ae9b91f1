"""Shared layers: norms, gated MLP, embeddings, logits head (port of
``repro/models/layers.py``)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.module import Param, ParamTree

Tensor = torch.Tensor


# --- RMSNorm ---------------------------------------------------------------

def rmsnorm_specs(d: int) -> Dict[str, Param]:
    return {"scale": Param((d,), init="ones")}


def rmsnorm(p: ParamTree, x: Tensor, eps: float) -> Tensor:
    """Computed in f32, then cast to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p.scale.to(torch.float32)).to(x.dtype)


# --- Gated MLP (llama-style) / plain GELU MLP -------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: int) -> Dict[str, Param]:
    d = cfg.d_model
    if cfg.mlp_act == "silu":
        return {
            "w_gate": Param((d, d_ff), init="fan_in"),
            "w_up": Param((d, d_ff), init="fan_in"),
            "w_down": Param((d_ff, d), init="fan_in"),
        }
    return {
        "w_up": Param((d, d_ff), init="fan_in"),
        "w_down": Param((d_ff, d), init="fan_in"),
    }


def mlp(p: ParamTree, cfg: ModelConfig, x: Tensor) -> Tensor:
    if cfg.mlp_act == "silu":
        h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    else:
        # jax.nn.gelu defaults to the tanh approximation; torch to erf.
        h = F.gelu(x @ p.w_up, approximate="tanh")
    return h @ p.w_down


# --- Embedding / logits ------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> Dict[str, Param]:
    return {"table": Param((cfg.vocab_size, cfg.d_model), init="embed",
                           scale=0.02)}


def embed(p: ParamTree, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    return p.table[tokens].to(cfg.cdtype)


def head_specs(cfg: ModelConfig) -> Dict[str, Param]:
    return {"w_out": Param((cfg.d_model, cfg.vocab_size), init="fan_in")}


def logits_head(p: ParamTree, x: Tensor) -> Tensor:
    return x @ p.w_out
