"""The causal language model (port of ``repro/models/model.py`` for the
decoder-only archs): embed -> layers -> final norm -> logits head.

``LanguageModel`` is an ``nn.Module`` whose ``state_dict`` keys follow the
JAX param tree with the period stack unstacked (``embed.table``,
``layers.{l}.attn.w_q``, ``ln_f.scale``, ``head.w_out``; see
``convert.lm_params_from_jax``).  ``impl`` (``auto | ref | cuda``) picks the
backend of the prefill's flash-attention and SSD ops; ``last_hidden`` runs
that prefill for the readout's frozen features.

Training: ``loss`` is the mean next-token cross-entropy (+ the weighted
MoE load-balance aux), over ``hidden_train`` run on the plain
differentiable functions (``mha_full``, ``ssm.ssd``), as JAX trains
through XLA: no kernel has a backward.  The head is applied chunk by
chunk over the sequence, each chunk recomputed in the backward under
``remat``, so the (B, S, V) logits never exist at once.  The parameters
are created without gradients (serving); ``requires_grad_(True)`` on the
model (``train/step.py`` does it) makes them trainable.  Whisper's
``encode`` and cross-attention frontends are not ported yet (ROADMAP.md
section 1, item 10).
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
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

    # --- training ---------------------------------------------------------

    def hidden_train(self, tokens: Tensor, frontend: Optional[Tensor] = None,
                     remat: bool = True, with_aux: bool = False):
        """Final-norm hidden states (B, S, D) of tokens (B, S) [, the MoE
        aux loss], through the plain differentiable functions, each period
        under ``torch.utils.checkpoint`` when ``remat``."""
        cfg = self.cfg
        if frontend is not None:
            raise NotImplementedError(f"{cfg.name}: {attn.UNPORTED['cross']}")
        x = layers.embed(self.embed, cfg, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        x, aux = blocks.apply_stack_train(self.layers, cfg, x, positions,
                                          remat=remat)
        h = layers.rmsnorm(self.ln_f, x, cfg.norm_eps)
        return (h, aux) if with_aux else h

    def logits(self, hidden: Tensor) -> Tensor:
        return layers.logits_head(self.head, hidden)

    def loss(self, tokens: Tensor, labels: Tensor,
             frontend: Optional[Tensor] = None, loss_chunks: int = 8,
             remat: bool = True) -> Tensor:
        """Mean next-token CE (+ ``moe_aux_weight`` x the MoE aux), the
        head applied chunk by chunk over the sequence (``loss_chunks``,
        lowered to a divisor of S)."""
        cfg = self.cfg
        h, aux = self.hidden_train(tokens, frontend, remat=remat,
                                   with_aux=True)
        b, s, _ = h.shape
        nc = loss_chunks
        while s % nc:
            nc -= 1
        qc = s // nc
        w_out = self.head.w_out

        def chunk_ce(hx, yx, w):
            lg = (hx @ w).to(torch.float32)
            lse = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, yx[..., None].long())[..., 0]
            return torch.sum(lse - gold)

        total = h.new_zeros((), dtype=torch.float32)
        for c0 in range(0, s, qc):
            args = (h[:, c0:c0 + qc], labels[:, c0:c0 + qc], w_out)
            total = total + (checkpoint(chunk_ce, *args, use_reentrant=False)
                             if remat else chunk_ce(*args))
        ce = total / (b * s)
        if cfg.has_moe and cfg.moe_aux_weight:
            ce = ce + cfg.moe_aux_weight * aux
        return ce

    # --- serving ------------------------------------------------------------

    def init_cache(self, batch: int, cache_len: int) -> List[Any]:
        return [blk.cache_init(batch, cache_len, self.device)
                for blk in self.layers]

    def _prefill_layers(self, tokens: Tensor, cache_len: int, impl: str
                        ) -> Tuple[Tensor, List[Any]]:
        """tokens (B, S) through every layer's prefill: (x, decode cache)."""
        x = layers.embed(self.embed, self.cfg, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        cache = []
        for blk in self.layers:
            x, c = blk.prefill(x, positions, cache_len, impl=impl)
            cache.append(c)
        return x, cache

    @torch.no_grad()
    def prefill(self, tokens: Tensor, cache_len: int
                ) -> Tuple[Tensor, List[Any]]:
        """tokens (B, S) -> (last-position logits (B, V), decode cache)."""
        x, cache = self._prefill_layers(tokens, cache_len, self.impl)
        h_last = layers.rmsnorm(self.ln_f, x[:, -1:, :], self.cfg.norm_eps)
        return layers.logits_head(self.head, h_last)[:, 0], cache

    @torch.no_grad()
    def last_hidden(self, tokens: Tensor, frontend: Optional[Tensor] = None,
                    impl: Optional[str] = None) -> Tensor:
        """Final-norm hidden state (B, D) of the last of tokens (B, S): the
        prefill's forward on backend ``impl`` (default the model's), its
        cache dropped (``core/readout.py``'s frozen features)."""
        cfg = self.cfg
        if frontend is not None:
            raise NotImplementedError(f"{cfg.name}: {attn.UNPORTED['cross']}")
        x, _ = self._prefill_layers(tokens, tokens.shape[1],
                                    impl or self.impl)
        return layers.rmsnorm(self.ln_f, x[:, -1, :], cfg.norm_eps)

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
