"""Transformer / SSM blocks (port of the train, prefill, decode and
cache-init modes of ``repro/models/blocks.py``).

Block kinds:
  attn / attn_local : [rmsnorm -> self-attention (GQA, or MLA when
                      ``cfg.use_mla``)] + [rmsnorm -> FFN/MoE]
  mamba             : [rmsnorm -> mamba-2 mixer] (+ FFN/MoE when d_ff > 0,
                      as in jamba)
  cross_attn        : [rmsnorm -> gated cross-attention over the frontend]
                      + [rmsnorm -> FFN] (llama-3.2-vision)
  attn_cross        : whisper's decoder block: self-attention, then
                      ungated cross-attention, then the FFN; its cache is
                      ``{"self": KVCache, "cross": CrossCache}``
An unknown kind raises ``ValueError``.  ``Block.forward_train``,
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

On a mesh (``ctx``, a ``MeshCtx``) each layer holds its parameters' local
slices; every mode reads them through ``ParamTree.view()``, which gathers
the dims sharded over the data axes for storage (ZeRO: "embed" under the
``train`` and ``decode`` rules) just before the layer runs and drops them
after (in training, inside the period's remat, so the backward gathers
again).  ``batch_split`` tells the MoE whether x is the rank's data shard
of the batch.  Every kind runs sharded: GQA, MLA, cross-attention,
mamba-2, the MLP and the MoE (``models/attention.py``, ``ssm.py``,
``moe.py``, ``layers.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe as moe_lib, ssm
from repro_torch.nn.module import ParamTree, held

Tensor = torch.Tensor


def _attn_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return attn.mla_specs(cfg) if cfg.use_mla else attn.gqa_specs(cfg)


def block_specs(cfg: ModelConfig, kind: str, is_moe: bool) -> Dict[str, Any]:
    d = cfg.d_model
    specs: Dict[str, Any] = {}
    if kind in ("attn", "attn_local"):
        specs["ln_attn"] = layers.rmsnorm_specs(d)
        specs["attn"] = _attn_specs(cfg)
    elif kind == "cross_attn":
        specs["ln_attn"] = layers.rmsnorm_specs(d)
        specs["xattn"] = attn.cross_specs(cfg)
    elif kind == "attn_cross":
        specs["ln_attn"] = layers.rmsnorm_specs(d)
        specs["attn"] = attn.gqa_specs(cfg)
        specs["ln_x"] = layers.rmsnorm_specs(d)
        specs["xattn"] = attn.cross_specs(cfg)
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


def _self_cache_names(cfg: ModelConfig, kind: str) -> Tuple[str, ...]:
    if cfg.use_mla and kind != "attn_cross":
        return ("batch", "kv_seq", "kv_lora")
    return ("batch", "kv_seq", "kv_heads", "head_dim")


class Block(ParamTree):
    """One layer: its parameters (JAX's names and shapes) and its three
    serving modes.  ``layout`` is the self-attention cache's
    ``CacheLayout``, set by ``cache_init`` and ``prefill`` and read by
    ``decode``."""

    def __init__(self, cfg: ModelConfig, kind: str, is_moe: bool, *,
                 dtype: torch.dtype, device: torch.device, ctx=None):
        super().__init__(block_specs(cfg, kind, is_moe), dtype=dtype,
                         device=device, ctx=ctx)
        self.cfg, self.kind, self.is_moe = cfg, kind, is_moe
        self.layout: Optional[attn.CacheLayout] = None

    def cache_layout(self, batch: int, cache_len: int
                     ) -> Optional[attn.CacheLayout]:
        """The self-attention cache's layout for a whole batch of
        ``batch`` and ``cache_len`` (before the local window's cut): JAX's
        spec (``block_cache_pspecs``) on the whole cache's shape.  None
        off a mesh and for kinds without a self-attention cache."""
        cfg, kind, ctx = self.cfg, self.kind, self.ctx
        if ctx is None or ctx.mesh is None or kind not in (
                "attn", "attn_local", "attn_cross"):
            return None
        c_len = _cache_len(cfg, kind, cache_len)
        if cfg.use_mla and kind != "attn_cross":
            shape: Tuple[int, ...] = (batch, c_len, cfg.kv_lora_rank)
        else:
            shape = (batch, c_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        spec = ctx.pspec(*_self_cache_names(cfg, kind), shape=shape)
        ranges = ctx.local_slice(shape, spec)
        seq = spec[1] if len(spec) > 1 else None
        kv_whole = len(shape) == 4 and ranges[2] == (0, cfg.n_kv_heads)
        return attn.CacheLayout(
            seq_axes=seq if seq is not None and ctx.size(seq) > 1 else None,
            c_len=c_len, lo=ranges[1][0], hi=ranges[1][1], kv_whole=kv_whole)

    def _cross_whole(self, batch: int, frontend_len: int) -> bool:
        """Whether the cross cache's spec holds every kv head."""
        cfg, ctx = self.cfg, self.ctx
        if ctx is None or ctx.mesh is None:
            return False
        shape = (batch, frontend_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        spec = ctx.pspec("batch", "frontend_seq", "kv_heads", "head_dim",
                         shape=shape)
        return ctx.local_slice(shape, spec)[2] == (0, cfg.n_kv_heads)

    def _ffn(self, x: Tensor, with_aux: bool = False, p=None,
             batch_split: bool = False):
        """x after the FFN / MoE (and the MoE load-balance aux loss when
        ``with_aux``: 0 for a dense or absent FFN); ``p`` the layer's
        parameters as read (default: the layer itself)."""
        p = self if p is None else p
        aux = x.new_zeros((), dtype=torch.float32) if with_aux else None
        if hasattr(self, "ffn"):
            h = layers.rmsnorm(p.ln_ffn, x, self.cfg.norm_eps)
            if self.is_moe and with_aux:
                out, aux = moe_lib.moe_forward(p.ffn, self.cfg, h,
                                               with_aux=True,
                                               batch_split=batch_split)
            elif self.is_moe:
                out = moe_lib.moe_forward(p.ffn, self.cfg, h,
                                          batch_split=batch_split)
            else:
                out = layers.mlp(p.ffn, self.cfg, h)
            x = x + out
        return (x, aux) if with_aux else x

    def _norm(self, name: str, x: Tensor, p=None) -> Tensor:
        return layers.rmsnorm(getattr(self if p is None else p, name), x,
                              self.cfg.norm_eps)

    def forward_train(self, x: Tensor, positions: Tensor,
                      frontend: Optional[Tensor] = None, causal: bool = True,
                      impl: Optional[str] = None,
                      batch_split: bool = False) -> Tuple[Tensor, Tensor]:
        """(x, moe aux loss) after the full sequence x (B,S,D), no cache,
        through the plain differentiable functions (``mha_full``,
        ``ssm.ssd``), as JAX trains.  ``frontend`` (B,Tf,D) feeds the
        cross-attention kinds; ``causal`` is False in whisper's encoder.
        ``impl`` (a backend name) runs self-attention through the flash op
        instead, as the encoder does in serving."""
        cfg, kind = self.cfg, self.kind
        p = self.view()
        if kind == "mamba":
            out = ssm.mamba_train(p.mixer, cfg, self._norm("ln_mix", x, p))
            return self._ffn(x + out, with_aux=True, p=p,
                             batch_split=batch_split)
        h = self._norm("ln_attn", x, p)
        if kind == "cross_attn":
            x = x + attn.cross_forward(p.xattn, cfg, h,
                                       attn.cross_kv(p.xattn, cfg, frontend))
        elif cfg.use_mla and kind != "attn_cross":
            x = x + attn.mla_forward(p.attn, cfg, h, positions)
        else:
            x = x + attn.gqa_forward(p.attn, cfg, h, positions,
                                     window=_window(cfg, kind),
                                     causal=causal, impl=impl)
        if kind == "attn_cross":
            x = x + attn.cross_forward(
                p.xattn, cfg, self._norm("ln_x", x, p),
                attn.cross_kv(p.xattn, cfg, frontend), gated=False)
        return self._ffn(x, with_aux=True, p=p, batch_split=batch_split)

    def prefill(self, x: Tensor, positions: Tensor, cache_len: int,
                frontend: Optional[Tensor] = None, impl: str = "auto",
                batch_split: bool = False, batch: Optional[int] = None):
        """(x, cache) after the full sequence x (B,S,D); ``frontend``
        (B,Tf,D) feeds the cross-attention kinds; ``batch`` is the whole
        batch's size (x's rows off a split)."""
        cfg, kind = self.cfg, self.kind
        batch = x.shape[0] if batch is None else batch
        self.layout = layout = self.cache_layout(batch, cache_len)
        p = self.view()
        if kind == "mamba":
            out, cache = ssm.mamba_forward(p.mixer, cfg,
                                           self._norm("ln_mix", x, p), impl=impl)
            return self._ffn(x + out, p=p, batch_split=batch_split), cache
        h = self._norm("ln_attn", x, p)
        if kind == "cross_attn":
            cache = attn.cross_kv(p.xattn, cfg, frontend, self._cross_whole(
                batch, frontend.shape[1]))
            out = attn.cross_forward(p.xattn, cfg, h, cache, impl=impl)
        elif cfg.use_mla and kind != "attn_cross":
            out, cache = attn.mla_prefill(p.attn, cfg, h, positions,
                                          cache_len=cache_len, layout=layout)
        else:
            out, cache = attn.gqa_prefill(
                p.attn, cfg, h, positions, window=_window(cfg, kind),
                cache_len=_cache_len(cfg, kind, cache_len), impl=impl,
                layout=layout)
        x = x + out
        if kind == "attn_cross":
            kv = attn.cross_kv(p.xattn, cfg, frontend, self._cross_whole(
                batch, frontend.shape[1]))
            x = x + attn.cross_forward(p.xattn, cfg, self._norm("ln_x", x, p),
                                       kv, gated=False, impl=impl)
            cache = {"self": cache, "cross": kv}
        return self._ffn(x, p=p, batch_split=batch_split), cache

    def decode(self, x: Tensor, cache, cur_pos: int,
               batch_split: bool = False):
        """(x, cache) after one token x (B,1,D) at position ``cur_pos``."""
        cfg, kind = self.cfg, self.kind
        p = self.view()
        if kind == "mamba":
            out, cache = ssm.mamba_decode(p.mixer, cfg,
                                          self._norm("ln_mix", x, p), cache)
            return self._ffn(x + out, p=p, batch_split=batch_split), cache
        h = self._norm("ln_attn", x, p)
        if kind == "cross_attn":
            out = attn.cross_forward(p.xattn, cfg, h, cache)
        elif cfg.use_mla and kind != "attn_cross":
            out, cache = attn.mla_decode(p.attn, cfg, h, cache, cur_pos,
                                         layout=self.layout)
        elif kind == "attn_cross":
            out, _ = attn.gqa_decode(p.attn, cfg, h, cache["self"],
                                     cur_pos, window=attn.GLOBAL_WINDOW,
                                     layout=self.layout)
        else:
            out, cache = attn.gqa_decode(p.attn, cfg, h, cache, cur_pos,
                                         window=_window(cfg, kind),
                                         layout=self.layout)
        x = x + out
        if kind == "attn_cross":
            x = x + attn.cross_forward(p.xattn, cfg, self._norm("ln_x", x, p),
                                       cache["cross"], gated=False)
        return self._ffn(x, p=p, batch_split=batch_split), cache

    def cache_init(self, batch: int, cache_len: int, frontend_len: int,
                   device: torch.device, whole_batch: Optional[int] = None):
        """An empty decode cache of this rank's part (all of it off a
        mesh): ``batch`` rows (the rank's share of ``whole_batch``), its
        heads, and the slots and kv heads of the self-attention cache's
        spec (``cache_layout``)."""
        cfg, kind = self.cfg, self.kind
        whole_batch = batch if whole_batch is None else whole_batch
        if kind == "mamba":
            lo, hi = ssm.local_heads(self.mixer, cfg)
            return ssm.init_mamba_cache(cfg, batch, device, n_heads=hi - lo)
        if kind == "cross_attn":
            return self._cross_cache(self.xattn, batch, whole_batch,
                                     frontend_len, device)
        self.layout = layout = self.cache_layout(whole_batch, cache_len)
        c_len = _cache_len(cfg, kind, cache_len)
        if layout is not None:
            c_len = layout.hi - layout.lo
        if cfg.use_mla and kind != "attn_cross":
            return attn.init_mla_cache(cfg, batch, c_len, device)
        if layout is not None and layout.kv_whole:
            n_kv = cfg.n_kv_heads
        else:
            lo, hi = held(self.attn, "w_k", 1)
            n_kv = hi - lo
        kv = attn.init_kv_cache(cfg, batch, c_len, device, n_kv=n_kv)
        if kind == "attn_cross":
            return {"self": kv,
                    "cross": self._cross_cache(self.xattn, batch, whole_batch,
                                               frontend_len, device)}
        return kv

    def _cross_cache(self, p, batch: int, whole_batch: int,
                     frontend_len: int, device: torch.device):
        if self._cross_whole(whole_batch, frontend_len):
            n_kv = self.cfg.n_kv_heads
        else:
            lo, hi = attn.local_kv_heads(p, self.cfg)
            n_kv = hi - lo
        return attn.init_cross_cache(self.cfg, batch, frontend_len, device,
                                     n_kv=n_kv)


def apply_stack_train(blocks: Sequence[Block], cfg: ModelConfig, x: Tensor,
                      positions: Tensor, frontend: Optional[Tensor] = None,
                      remat: bool = True, batch_split: bool = False
                      ) -> Tuple[Tensor, Tensor]:
    """x through the layers in order; returns (x, the MoE aux losses
    summed in layer order).  With ``remat`` each period's layers run under
    ``torch.utils.checkpoint`` (their activations are recomputed in the
    backward, as ``jax.checkpoint`` of JAX's period body, the ZeRO gathers
    and the collectives with them, in the same order on every rank); the
    remainder layers run plain, as in JAX."""

    def run(layer_blocks, h, aux):
        for blk in layer_blocks:
            h, a = blk.forward_train(h, positions, frontend,
                                     batch_split=batch_split)
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
