"""The language model (port of ``repro/models/model.py``, all ten archs):
[frontend ->] embed -> layers -> final norm -> logits head.

``LanguageModel`` is an ``nn.Module`` whose ``state_dict`` keys follow the
JAX param tree with the period stack unstacked (``embed.table``,
``layers.{l}.attn.w_q``, ``ln_f.scale``, ``head.w_out``, and whisper's
``encoder.layers.{i}.*`` / ``encoder.ln_f.scale``; see
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
model (``train/step.py`` does it) makes them trainable.

Frontends (``frontend`` on ``hidden_train``, ``loss``, ``prefill`` and
``last_hidden``): llama-3.2-vision's cross-attention layers attend over
the given embeddings (B, Tf, D) as they are; whisper runs its frames
through ``encode`` first (``encoder_layers`` non-causal ``attn`` blocks and
a final norm; in serving their attention runs the flash op, in training
``mha_full``).  Both are cast to the compute dtype first.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
        if cfg.encoder_layers:
            self.encoder = nn.Module()
            self.encoder.layers = nn.ModuleList(
                blocks.Block(cfg, "attn", False, **kw)
                for _ in range(cfg.encoder_layers))
            self.encoder.ln_f = ParamTree(layers.rmsnorm_specs(cfg.d_model),
                                          **kw)

    def init(self, generator: torch.Generator) -> "LanguageModel":
        """Random weights from ``generator`` (on the model's device)."""
        init_params(self, generator)
        return self

    # --- encoder (whisper) and frontends ----------------------------------

    def encode(self, frames: Tensor, impl: Optional[str] = None) -> Tensor:
        """The non-causal encoder over frame embeddings (B, Tf, D), cast to
        the compute dtype.  ``impl`` None: ``mha_full`` (differentiable);
        a backend name: the flash op, non-causal (serving)."""
        cfg = self.cfg
        positions = torch.arange(frames.shape[1], dtype=torch.int32,
                                 device=frames.device)
        x = frames.to(cfg.cdtype)
        for blk in self.encoder.layers:
            x, _ = blk.forward_train(x, positions, causal=False, impl=impl)
        return layers.rmsnorm(self.encoder.ln_f, x, cfg.norm_eps)

    def _frontend(self, frontend: Optional[Tensor],
                  impl: Optional[str]) -> Optional[Tensor]:
        if frontend is None:
            return None
        frontend = frontend.to(self.cfg.cdtype)
        if self.cfg.encoder_layers:
            return self.encode(frontend, impl)
        return frontend

    # --- training ---------------------------------------------------------

    def hidden_train(self, tokens: Tensor, frontend: Optional[Tensor] = None,
                     remat: bool = True, with_aux: bool = False):
        """Final-norm hidden states (B, S, D) of tokens (B, S) [, the MoE
        aux loss], through the plain differentiable functions, each period
        under ``torch.utils.checkpoint`` when ``remat``."""
        cfg = self.cfg
        fe = self._frontend(frontend, None)
        x = layers.embed(self.embed, cfg, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        x, aux = blocks.apply_stack_train(self.layers, cfg, x, positions,
                                          fe, remat=remat)
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
        return [blk.cache_init(batch, cache_len, self.cfg.n_frontend_tokens,
                               self.device)
                for blk in self.layers]

    def _prefill_layers(self, tokens: Tensor, cache_len: int, impl: str,
                        frontend: Optional[Tensor]
                        ) -> Tuple[Tensor, List[Any]]:
        """tokens (B, S) [and the frontend] through every layer's prefill:
        (x, decode cache)."""
        fe = self._frontend(frontend, impl)
        x = layers.embed(self.embed, self.cfg, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        cache = []
        for blk in self.layers:
            x, c = blk.prefill(x, positions, cache_len, fe, impl=impl)
            cache.append(c)
        return x, cache

    @torch.no_grad()
    def prefill(self, tokens: Tensor, cache_len: int,
                frontend: Optional[Tensor] = None
                ) -> Tuple[Tensor, List[Any]]:
        """tokens (B, S) [, frontend (B, Tf, D)] -> (last-position logits
        (B, V), decode cache)."""
        x, cache = self._prefill_layers(tokens, cache_len, self.impl,
                                        frontend)
        h_last = layers.rmsnorm(self.ln_f, x[:, -1:, :], self.cfg.norm_eps)
        return layers.logits_head(self.head, h_last)[:, 0], cache

    @torch.no_grad()
    def last_hidden(self, tokens: Tensor, frontend: Optional[Tensor] = None,
                    impl: Optional[str] = None) -> Tensor:
        """Final-norm hidden state (B, D) of the last of tokens (B, S): the
        prefill's forward on backend ``impl`` (default the model's), its
        cache dropped (``core/readout.py``'s frozen features)."""
        cfg = self.cfg
        x, _ = self._prefill_layers(tokens, tokens.shape[1],
                                    impl or self.impl, frontend)
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
