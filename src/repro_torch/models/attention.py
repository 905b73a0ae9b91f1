"""GQA self-attention (global / sliding-window) with a ring-buffer KV
cache (port of the GQA part of ``repro/models/attention.py``).

  * prefill: the full-sequence attention runs through the flash-attention
    op (``kernels/flash_attn``) where JAX runs ``mha_full``, its XLA form
    of the same online-softmax schedule;
  * train: ``gqa_forward`` runs ``mha_full``, the port of JAX's plain
    q-chunked attention, through autograd (no kernel has a backward);
  * decode: one query token against the cache, in plain torch.  Caches
    are ring buffers: ``slot = pos % cache_len`` with a per-slot position
    array for masking, so sliding-window layers carry only ``window``
    slots.  Unlike JAX's functional update, ``gqa_decode`` writes the new
    token into the cache tensors in place (no copy of the cache a step)
    and returns the same cache.

All softmax statistics are f32 regardless of compute dtype.  MLA
(deepseek-v3) and cross-attention (llama-3.2-vision, whisper) are not
ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.models.rotary import apply_rope
from repro_torch.nn.module import Param, ParamTree

Tensor = torch.Tensor

GLOBAL_WINDOW = 1 << 30   # "window" of a global-attention layer
NEG_INF = -1e30
UNPORTED = {
    "mla": "MLA attention (deepseek-v3) is not ported yet: ROADMAP.md "
           "section 1, item 10 (LM substrate: MLA)",
    "cross": "cross-attention (llama-3.2-vision's cross_attn, whisper's "
             "attn_cross and encoder) is not ported yet: ROADMAP.md "
             "section 1, item 10 (LM substrate: cross-attention, whisper)",
}


def gqa_specs(cfg: ModelConfig) -> Dict[str, Param]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "w_q": Param((d, h, hd), init="fan_in"),
        "w_k": Param((d, kv, hd), init="fan_in"),
        "w_v": Param((d, kv, hd), init="fan_in"),
        "w_o": Param((h, hd, d), init="fan_in"),
    }


class KVCache(NamedTuple):
    k: Tensor          # (B, C, Kv, Dh)
    v: Tensor          # (B, C, Kv, Dh)
    pos: Tensor        # (C,) int32 absolute position per slot, -1 = empty


def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  device: torch.device, dtype=None) -> KVCache:
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dtype = dtype or cfg.cdtype
    return KVCache(
        k=torch.zeros((batch, cache_len, kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, cache_len, kv, hd), dtype=dtype, device=device),
        pos=torch.full((cache_len,), -1, dtype=torch.int32, device=device),
    )


def _pick_q_chunk(s: int, q_chunk: int) -> int:
    """Largest divisor of s that is <= the requested chunk."""
    q_chunk = min(q_chunk, s)
    for d in range(q_chunk, 0, -1):
        if s % d == 0:
            return d
    return 1


def mha_full(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
             *, window: int, causal: bool, q_chunk: int = 512) -> Tensor:
    """q (B,S,H,Dh); k/v (B,T,Kv,Dh); positions (S,)/(T,) -> (B,S,H,Dv).

    Loops over q chunks so the transient score tile is (B,Kv,G,qc,T); the
    kv heads are grouped (q reshaped to (B,S,Kv,G,Dh)), never repeated.
    Scores and softmax in float32 (bf16 products are exact in float32, so
    casting first is JAX's ``preferred_element_type``); masked scores are
    -1e30."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kv
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    qg = q.reshape(b, s, kv, g, dh)
    qc = _pick_q_chunk(s, q_chunk)
    kf = k.float()
    outs = []
    for c0 in range(0, s, qc):
        p_blk = q_pos[c0:c0 + qc]
        scores = torch.einsum("bqkgd,btkd->bkgqt", qg[:, c0:c0 + qc].float(),
                              kf) * scale
        valid = (p_blk[:, None] - k_pos[None, :]) < window
        if causal:
            valid &= k_pos[None, :] <= p_blk[:, None]
        scores = torch.where(valid, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bkgqt,btkd->bqkgd", probs.to(v.dtype), v))
    return torch.cat(outs, dim=1).reshape(b, s, h, dv)


def _build_kv_cache(k: Tensor, v: Tensor, positions: Tensor, cache_len: int,
                    dtype) -> KVCache:
    """Lay freshly-computed K/V out as a ring-buffer cache of ``cache_len``."""
    s = k.shape[1]
    if s >= cache_len:
        k_w, v_w = k[:, -cache_len:], v[:, -cache_len:]
        p_w = positions[-cache_len:]
        inv = torch.argsort(p_w % cache_len, stable=True)
        return KVCache(k=k_w[:, inv].to(dtype), v=v_w[:, inv].to(dtype),
                       pos=p_w[inv].to(torch.int32))
    pad = cache_len - s
    kc = torch.cat([k.to(dtype), k.new_zeros((k.shape[0], pad) + k.shape[2:],
                                             dtype=dtype)], dim=1)
    vc = torch.cat([v.to(dtype), v.new_zeros((v.shape[0], pad) + v.shape[2:],
                                             dtype=dtype)], dim=1)
    pc = torch.cat([positions.to(torch.int32),
                    positions.new_full((pad,), -1, dtype=torch.int32)])
    return KVCache(k=kc, v=vc, pos=pc)


def _qkv(p: ParamTree, cfg: ModelConfig, x: Tensor, positions: Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p.w_q)
    k = torch.einsum("bsd,dhk->bshk", x, p.w_k)
    v = torch.einsum("bsd,dhk->bshk", x, p.w_v)
    q = apply_rope(q, positions[None], cfg.rope_theta)
    k = apply_rope(k, positions[None], cfg.rope_theta)
    return q, k, v


def gqa_forward(p: ParamTree, cfg: ModelConfig, x: Tensor,
                positions: Tensor, *, window: int, causal: bool = True,
                q_chunk: int = 512) -> Tensor:
    """The training path, no cache: x (B,S,D); positions (S,); attention
    through ``mha_full`` (differentiable)."""
    q, k, v = _qkv(p, cfg, x, positions)
    out = mha_full(q, k, v, positions, positions, window=window,
                   causal=causal, q_chunk=q_chunk)
    return torch.einsum("bshk,hkd->bsd", out, p.w_o)


def gqa_prefill(p: ParamTree, cfg: ModelConfig, x: Tensor,
                positions: Tensor, *, window: int, cache_len: int,
                impl: str = "auto") -> Tuple[Tensor, KVCache]:
    """Full-sequence causal attention through the flash-attention op, and
    the KV cache it leaves.  x (B,S,D); positions (S,) = arange(S)."""
    q, k, v = _qkv(p, cfg, x, positions)
    out = flash_attention(q, k, v, causal=True, window=window, impl=impl)
    out = torch.einsum("bshk,hkd->bsd", out, p.w_o)
    return out, _build_kv_cache(k, v, positions, cache_len, cfg.cdtype)


def gqa_decode(p: ParamTree, cfg: ModelConfig, x: Tensor, cache: KVCache,
               cur_pos: int, *, window: int) -> Tuple[Tensor, KVCache]:
    """One-token decode.  x (B,1,D); cur_pos a Python int.  Writes the new
    K/V into ``cache`` in place and returns it."""
    b = x.shape[0]
    kv, hd, h = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    g = h // kv
    pos1 = torch.tensor([cur_pos], dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, cfg, x, pos1)

    slot = cur_pos % cache.k.shape[1]
    cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
    cache.pos[slot] = cur_pos

    qg = q.reshape(b, kv, g, hd)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.float(), cache.k.float())
    scores = scores / math.sqrt(hd)
    cpos = cache.pos
    valid = (cpos >= 0) & (cpos <= cur_pos) & ((cur_pos - cpos) < window)
    scores = torch.where(valid[None, None, None], scores,
                         torch.tensor(NEG_INF, device=x.device))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", probs.to(cache.v.dtype), cache.v)
    o = o.reshape(b, 1, h, hd)
    return torch.einsum("bshk,hkd->bsd", o, p.w_o), cache
