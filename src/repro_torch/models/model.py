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

On a mesh (``ctx=MeshCtx.for_mesh(mesh, "decode")``) every rank holds its
slices of the parameters (``nn/module.py``) and serves SPMD: each rank is
given the whole batch of tokens (and frontend), runs its shard of it when
the batch divides over the axes of the rules' "batch" entry (the data
axes; none under ``long_decode``, where the caches' slots take them;
else all of it: JAX's rule), and ``prefill`` / ``decode_step`` return the
whole (B, V) logits on every rank, gathered over the vocab's model axis
and then over the batch's, so greedy tokens agree on every rank.  Decode
caches are laid out by JAX's cache specs (``Block.cache_layout``).

Training on a mesh (``ctx=MeshCtx.for_mesh(mesh, "train")``) takes the
batch the same way: ``loss`` is the mean cross-entropy over the rank's
data shard (+ the weighted aux loss, over the global tokens), and the
step's loss is the mean of the shards' (``train/step.py``).  The logits
stay split over the vocab's model axis: the cross-entropy takes the max
over the axis (a shift, no gradient) and sums the exponentials and the
gold logit over it (``collectives.psum``), never gathering the (B, S, V)
logits.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import collectives
from repro_torch.models import blocks, layers
from repro_torch.nn.module import ParamTree, axes, held, init_params


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The model's spec tree keyed as its ``state_dict`` (layers
    unstacked: ``layers.{l}``, ``encoder.layers.{i}``)."""
    moe_flags = cfg.moe_pattern or (False,) * cfg.period
    specs: Dict[str, Any] = {
        "embed": layers.embed_specs(cfg),
        "layers": {str(i): blocks.block_specs(
            cfg, cfg.layer_pattern[i % cfg.period], moe_flags[i % cfg.period])
            for i in range(cfg.n_layers)},
        "ln_f": layers.rmsnorm_specs(cfg.d_model),
        "head": layers.head_specs(cfg),
    }
    if cfg.encoder_layers:
        specs["encoder"] = {
            "layers": {str(i): blocks.block_specs(cfg, "attn", False)
                       for i in range(cfg.encoder_layers)},
            "ln_f": layers.rmsnorm_specs(cfg.d_model)}
    return specs

Tensor = torch.Tensor


class LanguageModel(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 param_dtype: Optional[torch.dtype] = None,
                 impl: str = "auto", ctx=None):
        super().__init__()
        self.cfg = cfg
        self.impl = impl
        self.ctx = ctx
        self.device = resolve_device(device)
        dtype = param_dtype or cfg.pdtype
        kw = dict(dtype=dtype, device=self.device, ctx=ctx)
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
        """Random weights from ``generator`` (on the model's device); on a
        mesh, this rank's slices of the unsharded model's draws."""
        init_params(self, generator)
        return self

    # --- the mesh -----------------------------------------------------------

    @property
    def sharded(self) -> bool:
        return self.ctx is not None and self.ctx.sharded

    def batch_split(self, batch: int) -> bool:
        """Whether a batch of ``batch`` rows runs split over the axes of
        the "batch" rule (the data axes, unless the rules say otherwise;
        none under ``long_decode``) because it divides over them (JAX's
        rule), else whole on every rank."""
        n = self.ctx.n_batch if self.sharded else 1
        return n > 1 and batch % n == 0

    def _local(self, t: Optional[Tensor]) -> Optional[Tensor]:
        """This rank's batch shard of a whole batch ``t`` (dim 0)."""
        if t is None or not self.batch_split(t.shape[0]):
            return t
        n = self.ctx.n_batch
        step = t.shape[0] // n
        lo = self.ctx.index(self.ctx.batch_axes) * step
        return t[lo:lo + step]

    def _whole_logits(self, h: Tensor, batch: int) -> Tensor:
        """The (B, ..., V) logits of the local hidden states ``h``: the
        local vocab slice gathered over its axes, the batch over data."""
        head = self.head.view()
        out = layers.logits_head(head, h)
        vocab_axes = axes(head, "w_out", 1)
        if vocab_axes is not None:
            out = collectives.all_gather(out, self.ctx, vocab_axes, dim=-1)
        if self.batch_split(batch):
            out = collectives.all_gather(out, self.ctx, self.ctx.batch_axes,
                                         dim=0)
        return out

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
        return layers.rmsnorm(self.encoder.ln_f.view(), x, cfg.norm_eps)

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
        under ``torch.utils.checkpoint`` when ``remat``.  On a mesh the
        rank's data shard of the batch (``batch_split``): (B_loc, S, D)."""
        cfg = self.cfg
        split = self.batch_split(tokens.shape[0])
        fe = self._frontend(self._local(frontend), None)
        tokens = self._local(tokens)
        x = layers.embed(self.embed.view(), cfg, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        x, aux = blocks.apply_stack_train(self.layers, cfg, x, positions,
                                          fe, remat=remat, batch_split=split)
        h = layers.rmsnorm(self.ln_f.view(), x, cfg.norm_eps)
        return (h, aux) if with_aux else h

    def logits(self, hidden: Tensor) -> Tensor:
        """The logits of this rank's vocab slice (all of them off a
        mesh)."""
        return layers.logits_head(self.head.view(), hidden)

    def loss(self, tokens: Tensor, labels: Tensor,
             frontend: Optional[Tensor] = None, loss_chunks: int = 8,
             remat: bool = True) -> Tensor:
        """Mean next-token CE (+ ``moe_aux_weight`` x the MoE aux), the
        head applied chunk by chunk over the sequence (``loss_chunks``,
        lowered to a divisor of S).  On a mesh: the mean over the rank's
        data shard of the batch, the logits split over the vocab's model
        axis (module docstring)."""
        cfg = self.cfg
        h, aux = self.hidden_train(tokens, frontend, remat=remat,
                                   with_aux=True)
        labels = self._local(labels)
        b, s, _ = h.shape
        nc = loss_chunks
        while s % nc:
            nc -= 1
        qc = s // nc
        head = self.head.view()
        w_out = head.w_out
        vocab_axes = axes(head, "w_out", 1) if self.sharded else None
        if vocab_axes is None:
            def chunk_ce(hx, yx, w):
                lg = (hx @ w).to(torch.float32)
                lse = torch.logsumexp(lg, dim=-1)
                gold = torch.gather(lg, -1, yx[..., None].long())[..., 0]
                return torch.sum(lse - gold)
        else:
            ctx = self.ctx
            lo, hi = held(head, "w_out", 1)
            h = collectives.to_split(h, ctx, vocab_axes)

            def chunk_ce(hx, yx, w):
                lg = (hx @ w).to(torch.float32)           # this vocab slice
                top = collectives.pmax(lg.detach().amax(dim=-1), ctx,
                                       vocab_axes)
                sum_exp = collectives.psum(
                    torch.sum(torch.exp(lg - top[..., None]), dim=-1), ctx,
                    vocab_axes)
                lse = top + torch.log(sum_exp)
                ids = yx.long() - lo
                mine = (ids >= 0) & (ids < hi - lo)
                gold = torch.gather(lg, -1, torch.where(
                    mine, ids, 0)[..., None])[..., 0]
                gold = collectives.psum(
                    torch.where(mine, gold, gold.new_zeros(())), ctx,
                    vocab_axes)
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
        """Empty decode caches for a batch of ``batch`` (this rank's data
        shard of it and its heads, on a mesh)."""
        whole = batch
        if self.batch_split(batch):
            batch //= self.ctx.n_batch
        return [blk.cache_init(batch, cache_len, self.cfg.n_frontend_tokens,
                               self.device, whole_batch=whole)
                for blk in self.layers]

    def _prefill_layers(self, tokens: Tensor, cache_len: int, impl: str,
                        frontend: Optional[Tensor]
                        ) -> Tuple[Tensor, List[Any]]:
        """tokens (B, S) [and the frontend] through every layer's prefill:
        (x, decode cache), x of this rank's data shard of the batch."""
        batch = tokens.shape[0]
        split = self.batch_split(batch)
        fe = self._frontend(self._local(frontend), impl)
        tokens = self._local(tokens)
        x = layers.embed(self.embed.view(), self.cfg, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        cache = []
        for blk in self.layers:
            x, c = blk.prefill(x, positions, cache_len, fe, impl=impl,
                               batch_split=split, batch=batch)
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
        h_last = layers.rmsnorm(self.ln_f.view(), x[:, -1:, :],
                                self.cfg.norm_eps)
        return self._whole_logits(h_last, tokens.shape[0])[:, 0], cache

    @torch.no_grad()
    def last_hidden(self, tokens: Tensor, frontend: Optional[Tensor] = None,
                    impl: Optional[str] = None) -> Tensor:
        """Final-norm hidden state (B, D) of the last of tokens (B, S): the
        prefill's forward on backend ``impl`` (default the model's), its
        cache dropped (``core/readout.py``'s frozen features)."""
        cfg = self.cfg
        x, _ = self._prefill_layers(tokens, tokens.shape[1],
                                    impl or self.impl, frontend)
        h = layers.rmsnorm(self.ln_f.view(), x[:, -1, :], cfg.norm_eps)
        if self.batch_split(tokens.shape[0]):
            h = collectives.all_gather(h, self.ctx, self.ctx.batch_axes)
        return h

    @torch.no_grad()
    def decode_step(self, token: Tensor, cache: List[Any], cur_pos: int
                    ) -> Tuple[Tensor, List[Any]]:
        """token (B,) at position ``cur_pos`` -> ((B, V) logits, cache).
        KV caches are updated in place."""
        cfg = self.cfg
        split = self.batch_split(token.shape[0])
        x = layers.embed(self.embed.view(), cfg, self._local(token)[:, None])
        new = []
        for blk, c in zip(self.layers, cache):
            x, c = blk.decode(x, c, cur_pos, batch_split=split)
            new.append(c)
        h = layers.rmsnorm(self.ln_f.view(), x, cfg.norm_eps)
        return self._whole_logits(h, token.shape[0])[:, 0], new
