"""Transformer / SSM blocks (port of the train, prefill, decode and
cache-init modes of ``repro/models/blocks.py``).

Block kinds ported:
  attn / attn_local : [rmsnorm -> GQA self-attention] + [rmsnorm -> FFN/MoE]
  mamba             : [rmsnorm -> mamba-2 mixer] (+ FFN/MoE when d_ff > 0,
                      as in jamba)
``cross_attn`` and ``attn_cross`` (and MLA attention) raise
``NotImplementedError`` naming their ROADMAP item.  ``Block.forward_train``,
``Block.prefill``, ``Block.decode`` and ``Block.cache_init`` are JAX's
``block_train``, ``block_prefill``, ``block_decode`` and
``block_cache_init``; ``Block._ffn`` and ``_window`` keep their names.

JAX stacks the parameters of all periods under ``stack/scan/pos{i}`` and
scans over them; the port keeps one ``Block`` per layer in layer order
(``LanguageModel.layers``), layer ``p * period + i`` holding period ``p``'s
``pos{i}`` and the remainder layers following (``convert.py`` does the
unstacking).  ``apply_stack_train`` runs them, each period under
``torch.utils.checkpoint`` when ``remat`` is on (JAX's ``jax.checkpoint``
of the period body).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe as moe_lib, ssm
from repro_torch.nn.module import ParamTree

Tensor = torch.Tensor
KINDS = ("attn", "attn_local", "mamba")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot run yet."""
    if cfg.use_mla:
        raise NotImplementedError(f"{cfg.name}: {attn.UNPORTED['mla']}")
    if cfg.encoder_layers or any(k not in KINDS for k in cfg.layer_pattern):
        raise NotImplementedError(f"{cfg.name}: {attn.UNPORTED['cross']}")


def block_specs(cfg: ModelConfig, kind: str, is_moe: bool) -> Dict[str, Any]:
    d = cfg.d_model
    specs: Dict[str, Any] = {}
    if kind in ("attn", "attn_local"):
        specs["ln_attn"] = layers.rmsnorm_specs(d)
        specs["attn"] = attn.gqa_specs(cfg)
    elif kind == "mamba":
        specs["ln_mix"] = layers.rmsnorm_specs(d)
        specs["mixer"] = ssm.mamba_specs(cfg)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    if is_moe:
        specs["ln_ffn"] = layers.rmsnorm_specs(d)
        specs["ffn"] = moe_lib.moe_specs(cfg)
    elif cfg.d_ff > 0:
        specs["ln_ffn"] = layers.rmsnorm_specs(d)
        specs["ffn"] = layers.mlp_specs(cfg, cfg.d_ff)
    return specs


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if kind == "attn_local" else attn.GLOBAL_WINDOW


def _cache_len(cfg: ModelConfig, kind: str, cache_len: int) -> int:
    return min(cache_len, cfg.window) if kind == "attn_local" else cache_len


class Block(ParamTree):
    """One layer: its parameters (JAX's names and shapes) and its three
    serving modes."""

    def __init__(self, cfg: ModelConfig, kind: str, is_moe: bool, *,
                 dtype: torch.dtype, device: torch.device):
        super().__init__(block_specs(cfg, kind, is_moe), dtype=dtype,
                         device=device)
        self.cfg, self.kind, self.is_moe = cfg, kind, is_moe

    def _ffn(self, x: Tensor, with_aux: bool = False):
        """x after the FFN / MoE (and the MoE load-balance aux loss when
        ``with_aux``: 0 for a dense or absent FFN)."""
        aux = x.new_zeros((), dtype=torch.float32) if with_aux else None
        if hasattr(self, "ffn"):
            h = layers.rmsnorm(self.ln_ffn, x, self.cfg.norm_eps)
            if self.is_moe and with_aux:
                out, aux = moe_lib.moe_forward(self.ffn, self.cfg, h,
                                               with_aux=True)
            elif self.is_moe:
                out = moe_lib.moe_forward(self.ffn, self.cfg, h)
            else:
                out = layers.mlp(self.ffn, self.cfg, h)
            x = x + out
        return (x, aux) if with_aux else x

    def forward_train(self, x: Tensor,
                      positions: Tensor) -> Tuple[Tensor, Tensor]:
        """(x, moe aux loss) after the full sequence x (B,S,D), no cache,
        through the plain differentiable functions (``mha_full``,
        ``ssm.ssd``), as JAX trains."""
        cfg = self.cfg
        if self.kind == "mamba":
            h = layers.rmsnorm(self.ln_mix, x, cfg.norm_eps)
            out = ssm.mamba_train(self.mixer, cfg, h)
        else:
            h = layers.rmsnorm(self.ln_attn, x, cfg.norm_eps)
            out = attn.gqa_forward(self.attn, cfg, h, positions,
                                   window=_window(cfg, self.kind))
        return self._ffn(x + out, with_aux=True)

    def prefill(self, x: Tensor, positions: Tensor, cache_len: int,
                impl: str = "auto"):
        """(x, cache) after the full sequence x (B,S,D)."""
        cfg = self.cfg
        if self.kind == "mamba":
            h = layers.rmsnorm(self.ln_mix, x, cfg.norm_eps)
            out, cache = ssm.mamba_forward(self.mixer, cfg, h, impl=impl)
        else:
            h = layers.rmsnorm(self.ln_attn, x, cfg.norm_eps)
            out, cache = attn.gqa_prefill(
                self.attn, cfg, h, positions, window=_window(cfg, self.kind),
                cache_len=_cache_len(cfg, self.kind, cache_len), impl=impl)
        return self._ffn(x + out), cache

    def decode(self, x: Tensor, cache, cur_pos: int):
        """(x, cache) after one token x (B,1,D) at position ``cur_pos``."""
        cfg = self.cfg
        if self.kind == "mamba":
            h = layers.rmsnorm(self.ln_mix, x, cfg.norm_eps)
            out, cache = ssm.mamba_decode(self.mixer, cfg, h, cache)
        else:
            h = layers.rmsnorm(self.ln_attn, x, cfg.norm_eps)
            out, cache = attn.gqa_decode(self.attn, cfg, h, cache, cur_pos,
                                         window=_window(cfg, self.kind))
        return self._ffn(x + out), cache

    def cache_init(self, batch: int, cache_len: int, device: torch.device):
        if self.kind == "mamba":
            return ssm.init_mamba_cache(self.cfg, batch, device)
        return attn.init_kv_cache(
            self.cfg, batch, _cache_len(self.cfg, self.kind, cache_len),
            device)


def apply_stack_train(blocks: Sequence[Block], cfg: ModelConfig, x: Tensor,
                      positions: Tensor,
                      remat: bool = True) -> Tuple[Tensor, Tensor]:
    """x through the layers in order; returns (x, the MoE aux losses
    summed in layer order).  With ``remat`` each period's layers run under
    ``torch.utils.checkpoint`` (their activations are recomputed in the
    backward, as ``jax.checkpoint`` of JAX's period body); the remainder
    layers run plain, as in JAX."""

    def run(layer_blocks, h, aux):
        for blk in layer_blocks:
            h, a = blk.forward_train(h, positions)
            aux = aux + a
        return h, aux

    aux = x.new_zeros((), dtype=torch.float32)
    n_scan = cfg.n_periods * cfg.period
    for p0 in range(0, n_scan, cfg.period):
        period = blocks[p0:p0 + cfg.period]
        if remat:
            x, aux = checkpoint(run, period, x, aux, use_reentrant=False)
        else:
            x, aux = run(period, x, aux)
    return run(blocks[n_scan:], x, aux)
