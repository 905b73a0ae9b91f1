"""The causal language model for serving (port of the serving part of
``repro/models/model.py``): embed -> layers -> final norm -> logits head.

``LanguageModel`` is an ``nn.Module`` whose ``state_dict`` keys follow the
JAX param tree with the period stack unstacked (``embed.table``,
``layers.{l}.attn.w_q``, ``ln_f.scale``, ``head.w_out``; see
``convert.lm_params_from_jax``).  ``impl`` (``auto | ref | cuda``) picks the
backend of the prefill's flash-attention and SSD ops.  Training
(``loss``, ``hidden_train``) and whisper's ``encode`` are not ported yet
(ROADMAP.md section 1, item 10).
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks, layers
from repro_torch.nn.module import ParamTree, init_params

Tensor = torch.Tensor


class LanguageModel(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 param_dtype: Optional[torch.dtype] = None,
                 impl: str = "auto"):
        super().__init__()
        blocks.check_supported(cfg)
        self.cfg = cfg
        self.impl = impl
        self.device = resolve_device(device)
        dtype = param_dtype or cfg.pdtype
        kw = dict(dtype=dtype, device=self.device)
        self.embed = ParamTree(layers.embed_specs(cfg), **kw)
        moe_flags = cfg.moe_pattern or (False,) * cfg.period
        self.layers = nn.ModuleList(
            blocks.Block(cfg, cfg.layer_pattern[i % cfg.period],
                         moe_flags[i % cfg.period], **kw)
            for i in range(cfg.n_layers))
        self.ln_f = ParamTree(layers.rmsnorm_specs(cfg.d_model), **kw)
        self.head = ParamTree(layers.head_specs(cfg), **kw)

    def init(self, generator: torch.Generator) -> "LanguageModel":
        """Random weights from ``generator`` (on the model's device)."""
        init_params(self, generator)
        return self

    def init_cache(self, batch: int, cache_len: int) -> List[Any]:
        return [blk.cache_init(batch, cache_len, self.device)
                for blk in self.layers]

    @torch.no_grad()
    def prefill(self, tokens: Tensor, cache_len: int
                ) -> Tuple[Tensor, List[Any]]:
        """tokens (B, S) -> (last-position logits (B, V), decode cache)."""
        cfg = self.cfg
        x = layers.embed(self.embed, cfg, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        cache = []
        for blk in self.layers:
            x, c = blk.prefill(x, positions, cache_len, impl=self.impl)
            cache.append(c)
        h_last = layers.rmsnorm(self.ln_f, x[:, -1:, :], cfg.norm_eps)
        return layers.logits_head(self.head, h_last)[:, 0], cache

    @torch.no_grad()
    def decode_step(self, token: Tensor, cache: List[Any], cur_pos: int
                    ) -> Tuple[Tensor, List[Any]]:
        """token (B,) at position ``cur_pos`` -> ((B, V) logits, cache).
        KV caches are updated in place."""
        cfg = self.cfg
        x = layers.embed(self.embed, cfg, token[:, None])
        new = []
        for blk, c in zip(self.layers, cache):
            x, c = blk.decode(x, c, cur_pos)
            new.append(c)
        h = layers.rmsnorm(self.ln_f, x, cfg.norm_eps)
        return layers.logits_head(self.head, h)[:, 0], new
