"""Attention: GQA (global / sliding-window), MLA (deepseek-v3) and
cross-attention (llama-3.2-vision, whisper) with their decode caches (port
of ``repro/models/attention.py``).

  * prefill: GQA's full-sequence attention, causal or not, and
    cross-attention's run through the flash-attention op
    (``kernels/flash_attn``) where JAX runs ``mha_full``, its XLA form of
    the same online-softmax schedule (cross-attention with zero positions:
    every key is valid, as in the non-causal op);
  * train: ``gqa_forward``, ``cross_forward`` and ``mla_forward`` run
    ``mha_full``, the port of JAX's plain q-chunked attention, through
    autograd (no kernel has a backward);
  * MLA's full-sequence attention runs ``mha_full`` in prefill too, as
    JAX's ``mla_prefill`` does: its qk head dim (192) differs from its v
    head dim (128), which neither flash route takes;
  * decode: one query token against the cache, in plain torch.  Caches
    are ring buffers: ``slot = pos % cache_len`` with a per-slot position
    array for masking, so sliding-window layers carry only ``window``
    slots.  Unlike JAX's functional update, ``gqa_decode`` and
    ``mla_decode`` write the new token into the cache tensors in place
    (no copy of the cache a step) and return the same cache.  MLA decodes
    in the absorbed form: scores and context in the compressed c_kv
    space.

All softmax statistics are f32 regardless of compute dtype.

On a mesh (``ParamTree`` under a ``MeshCtx``) GQA runs on this rank's q
heads (the rules split "heads" over the model axis): its kv heads are
split with them where they divide, else held whole and each rank takes
the kv heads of its own q-head groups (granite's one kv head).  The flash
op sees (B, S, H_loc, Kv_loc, D), the KV cache holds the local kv heads,
and ``w_o``'s partial products are summed over the model axis in float32
(``collectives.psum_product``).  Cross-attention is GQA's layout over the
frontend's K / V: the cross cache holds the local kv heads, the flash op
runs non-causally at the local head counts, and the gate is whole.  A
head count that does not divide the model axis (whisper-tiny's 6 on 4)
leaves the heads whole and the layer replicated.

MLA on a mesh follows the ``train`` / ``decode`` rules: ``w_dq`` splits
q_lora over the model axis (``q_norm`` with it: the RMS's sum of squares
is summed over the axis), ``w_uq`` holds all heads over this rank's
q_lora slice (its contraction summed over the axis by ``psum_product``),
of which the rank keeps the q heads its ``w_uk`` / ``w_uv`` / ``w_o``
hold; ``w_dkv`` and ``kv_norm`` are whole, so c_kv and k_rope, and the
MLA cache, are whole over the model axis (split over data with the
batch); the absorbed decode runs over the local heads and ``w_o``'s
products are summed as GQA's.

Caches follow JAX's specs (``Block.cache_layout``): a KV cache is laid
out by ("batch", "kv_seq", "kv_heads", "head_dim"), an MLA cache by
("batch", "kv_seq", "kv_lora") and ("batch", "kv_seq", None), a cross
cache by ("batch", "frontend_seq", "kv_heads", "head_dim"), each mesh
axis used once a spec and a dim that does not divide held whole.  So a
cache holds every kv head where the spec leaves them whole (the rank
computes them all: such a ``w_k`` is whole on every rank) and attends
with its q-head groups' ones.  Where the spec splits the sequence
(``kv_seq``: over the data axes under the ``long_decode`` rules, over
the model axis under the dry-run's decode override) each rank holds its
``CacheLayout`` slice of the slots: the prefill keeps its slice of the
ring, a decode step writes the new token only on the rank that owns its
slot, and each rank attends over its slots, the softmax combined over
the sequence's axes as flash-decoding does (the max by ``pmax``, the sum
of exponentials and the weighted values by ``psum``).  Where the q heads
are split over an axis that also splits the sequence, q is gathered over
it first (one token: tiny), every head attends over the rank's slots,
and the rank keeps its own heads after the combine.

In training each tensor replicated over the model axis that enters a
rank's split part (the layer's input before a head-split projection, a
replicated weight used on the local heads, MLA's c_kv, k_rope and whole
q) goes through ``collectives.to_split``, whose backward sums its
gradient over the axis.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.models.rotary import apply_rope
from repro_torch.distributed.sharding import as_axes
from repro_torch.nn.module import Param, ParamTree, axes, held

Tensor = torch.Tensor

GLOBAL_WINDOW = 1 << 30   # "window" of a global-attention layer
NEG_INF = -1e30


def gqa_specs(cfg: ModelConfig) -> Dict[str, Param]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "w_q": Param((d, h, hd), init="fan_in",
                     logical=("embed", "heads", "head_dim")),
        "w_k": Param((d, kv, hd), init="fan_in",
                     logical=("embed", "kv_heads", "head_dim")),
        "w_v": Param((d, kv, hd), init="fan_in",
                     logical=("embed", "kv_heads", "head_dim")),
        "w_o": Param((h, hd, d), init="fan_in",
                     logical=("heads", "head_dim", "embed")),
    }


def mla_specs(cfg: ModelConfig) -> Dict[str, Param]:
    d, h = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    qk_n, qk_r, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "w_dq": Param((d, rq), init="fan_in", logical=("embed", "q_lora")),
        "q_norm": Param((rq,), init="ones", logical=("q_lora",)),
        "w_uq": Param((rq, h, qk_n + qk_r), init="fan_in",
                      logical=("q_lora", "heads", None)),
        "w_dkv": Param((d, rkv + qk_r), init="fan_in",
                       logical=("embed", "kv_lora")),
        "kv_norm": Param((rkv,), init="ones", logical=("kv_lora",)),
        "w_uk": Param((rkv, h, qk_n), init="fan_in",
                      logical=("kv_lora", "heads", None)),
        "w_uv": Param((rkv, h, vh), init="fan_in",
                      logical=("kv_lora", "heads", None)),
        "w_o": Param((h, vh, d), init="fan_in",
                     logical=("heads", "head_dim", "embed")),
    }


def cross_specs(cfg: ModelConfig) -> Dict[str, Param]:
    """GQA's projections and llama-3.2-vision's tanh gate (zero at init;
    kept where it is unused, as in whisper, so that JAX's tree loads
    whole)."""
    specs = gqa_specs(cfg)
    specs["gate"] = Param((1,), init="zeros", logical=(None,))
    return specs


def _rms(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """MLA's low-rank norms: RMSNorm in f32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


class KVCache(NamedTuple):
    k: Tensor          # (B, C, Kv, Dh)
    v: Tensor          # (B, C, Kv, Dh)
    pos: Tensor        # (C,) int32 absolute position per slot, -1 = empty


class CacheLayout(NamedTuple):
    """How a self-attention cache lies over the mesh (``Block.cache_layout``):
    the mesh axes that split its slots (``None``: whole), the whole
    cache's ``c_len`` slots and this rank's ``[lo, hi)`` of them, and
    whether it holds every kv head (the spec leaves them whole)."""
    seq_axes: Any = None
    c_len: int = 0
    lo: int = 0
    hi: int = 0
    kv_whole: bool = False

    def own(self, t: Tensor, dim: int = 1) -> Tensor:
        """This rank's slots of a whole cache tensor ``t``."""
        if self.seq_axes is None:
            return t
        return t.narrow(dim, self.lo, self.hi - self.lo).contiguous()



def _slot(layout: Optional[CacheLayout], cur_pos: int, held: int
          ) -> Optional[int]:
    """The slot of position ``cur_pos`` in a cache of ``held`` slots laid
    out by ``layout``, or None when another rank owns it."""
    if layout is None or layout.seq_axes is None:
        return cur_pos % held
    if held != layout.hi - layout.lo:
        raise ValueError(f"a cache of {held} slots under a layout of "
                         f"{layout.hi - layout.lo}: decode a cache with the "
                         "layout its prefill or init_cache left")
    slot = cur_pos % layout.c_len
    return slot - layout.lo if layout.lo <= slot < layout.hi else None


def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  device: torch.device, dtype=None,
                  n_kv: Optional[int] = None) -> KVCache:
    """An empty cache of ``n_kv`` kv heads (default: all of them)."""
    kv, hd = n_kv or cfg.n_kv_heads, cfg.resolved_head_dim
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


def local_kv_heads(p: ParamTree, cfg: ModelConfig) -> Tuple[int, int]:
    """The ``[start, stop)`` of the kv heads this rank attends with: the
    ones it holds where the rules split them with the q heads; where kv
    heads are whole (they do not divide) but q heads are split, the kv
    heads of this rank's q-head groups."""
    if axes(p, "w_q", 1) is None or axes(p, "w_k", 1) is not None:
        return held(p, "w_k", 1)
    lo, hi = held(p, "w_q", 1)
    g = cfg.n_heads // cfg.n_kv_heads
    klo, khi = lo // g, -(-hi // g)
    if khi - klo > 1 and (lo % g or (hi - lo) % g):
        raise ValueError(
            f"{cfg.name}: q heads [{lo}, {hi}) straddle the groups of its "
            f"{cfg.n_kv_heads} kv heads; the model axis must split the "
            f"{cfg.n_heads} q heads into whole groups of {g} or into parts "
            "of one group")
    return klo, khi


def _kv_weights(p: ParamTree, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """``w_k``, ``w_v`` over this rank's kv heads (``local_kv_heads``).
    Whole kv heads under split q heads are replicated weights used on the
    local heads: ``to_split`` sums their gradients over the model axis."""
    over = axes(p, "w_q", 1)
    if over is None or axes(p, "w_k", 1) is not None:
        return p.w_k, p.w_v
    klo, khi = local_kv_heads(p, cfg)
    return (collectives.to_split(p.w_k, p.ctx, over)[:, klo:khi],
            collectives.to_split(p.w_v, p.ctx, over)[:, klo:khi])


def _split_input(p: ParamTree, x: Tensor) -> Tensor:
    """x entering the projections of the local q heads (``to_split`` over
    the heads' axes; x itself when the heads are whole)."""
    return collectives.to_split(x, p.ctx, axes(p, "w_q", 1))


def _out_proj(p: ParamTree, o: Tensor) -> Tensor:
    """o (B,S,H_loc,Dh) through ``w_o``, summed over the heads' axes."""
    return collectives.psum_product(
        lambda a, b: torch.einsum("bshk,hkd->bsd", a, b), o, p.w_o, p.ctx,
        axes(p, "w_o", 0))


def _qkv(p: ParamTree, cfg: ModelConfig, x: Tensor, positions: Tensor):
    w_k, w_v = _kv_weights(p, cfg)
    x = _split_input(p, x)
    q = torch.einsum("bsd,dhk->bshk", x, p.w_q)
    k = torch.einsum("bsd,dhk->bshk", x, w_k)
    v = torch.einsum("bsd,dhk->bshk", x, w_v)
    q = apply_rope(q, positions[None], cfg.rope_theta)
    k = apply_rope(k, positions[None], cfg.rope_theta)
    return q, k, v


def gqa_forward(p: ParamTree, cfg: ModelConfig, x: Tensor,
                positions: Tensor, *, window: int, causal: bool = True,
                q_chunk: int = 512, impl: Optional[str] = None) -> Tensor:
    """Full-sequence attention, no cache: x (B,S,D); positions (S,) =
    arange(S).  ``impl`` None runs ``mha_full`` (differentiable: the
    training path); a backend name runs the flash op on it (the encoder
    in serving, non-causal)."""
    q, k, v = _qkv(p, cfg, x, positions)
    if impl is None:
        out = mha_full(q, k, v, positions, positions, window=window,
                       causal=causal, q_chunk=q_chunk)
    else:
        out = flash_attention(q, k, v, causal=causal, window=window,
                              impl=impl)
    return _out_proj(p, out)


def _cache_kv(p: ParamTree, cfg: ModelConfig, x: Tensor,
              positions: Optional[Tensor], whole: bool
              ) -> Tuple[Tensor, Tensor]:
    """K / V (B,S,kv,Dh) of x over the kv heads a cache holds: every one
    when ``whole`` (computed from a whole ``w_k``, or gathered where the
    model axis splits it while the cache spec gave that axis to the
    sequence), else the rank's ``w_k`` heads.  Roped at ``positions``
    unless None (cross-attention's keys carry no rotation)."""
    lo, hi = held(p, "w_k", 1)
    gather = None
    if not whole or hi - lo == cfg.n_kv_heads:
        w_k, w_v = p.w_k, p.w_v
    else:
        w_k, w_v, gather = p.w_k, p.w_v, axes(p, "w_k", 1)
    k = torch.einsum("bsd,dhk->bshk", x, w_k)
    v = torch.einsum("bsd,dhk->bshk", x, w_v)
    if gather is not None:
        k = collectives.all_gather(k, p.ctx, gather, dim=2)
        v = collectives.all_gather(v, p.ctx, gather, dim=2)
    if positions is not None:
        k = apply_rope(k, positions[None], cfg.rope_theta)
    return k, v


def _group_kv(p: ParamTree, cfg: ModelConfig, n_cached: int
              ) -> Tuple[int, int]:
    """The ``[start, stop)`` of this rank's q-head groups' kv heads within
    a cache of ``n_cached`` kv heads (all of them, or the rank's ``w_k``
    heads)."""
    klo, khi = local_kv_heads(p, cfg)
    off = 0 if n_cached == cfg.n_kv_heads else held(p, "w_k", 1)[0]
    return klo - off, khi - off


def _probs(scores: Tensor, ctx, seq_axes) -> Tensor:
    """softmax of float32 ``scores`` over their last dim, the slots of
    every rank on ``seq_axes`` (None: this rank's alone) included."""
    if seq_axes is None:
        return torch.softmax(scores, dim=-1)
    top = collectives.pmax(scores.amax(dim=-1, keepdim=True), ctx, seq_axes)
    e = torch.exp(scores - top)
    return e / collectives.psum(e.sum(dim=-1, keepdim=True), ctx, seq_axes)


def _sum_slots(o: Tensor, ctx, seq_axes) -> Tensor:
    """A probability-weighted sum of values over this rank's slots summed
    over ``seq_axes`` (in float32, rounded once to o's dtype)."""
    if seq_axes is None:
        return o
    return collectives.psum(o.float(), ctx, seq_axes).to(o.dtype)


def _heads_meet_slots(p: ParamTree, name: str, dim: int,
                      layout: Optional[CacheLayout]) -> Any:
    """The axes splitting the q heads (dim ``dim`` of ``name``) when one
    of them also splits the cache's slots, else None: there a rank needs
    every head's partial over its slots."""
    if layout is None or layout.seq_axes is None:
        return None
    over = axes(p, name, dim)
    if over is None:
        return None
    seq = set(as_axes(layout.seq_axes))
    return over if seq & set(as_axes(over)) else None


def gqa_prefill(p: ParamTree, cfg: ModelConfig, x: Tensor,
                positions: Tensor, *, window: int, cache_len: int,
                impl: str = "auto", layout: Optional[CacheLayout] = None
                ) -> Tuple[Tensor, KVCache]:
    """Full-sequence causal attention through the flash-attention op, and
    the KV cache it leaves (this rank's ``layout`` of it; whole off a
    mesh).  x (B,S,D); positions (S,) = arange(S)."""
    q = torch.einsum("bsd,dhk->bshk", _split_input(p, x), p.w_q)
    q = apply_rope(q, positions[None], cfg.rope_theta)
    whole = layout is not None and layout.kv_whole
    k, v = _cache_kv(p, cfg, x, positions, whole)
    glo, ghi = _group_kv(p, cfg, k.shape[2])
    out = flash_attention(q, k[:, :, glo:ghi], v[:, :, glo:ghi], causal=True,
                          window=window, impl=impl)
    cache = _build_kv_cache(k, v, positions, cache_len, cfg.cdtype)
    if layout is not None:
        cache = KVCache(*(layout.own(t, dim=1 if t.dim() > 1 else 0)
                          for t in cache))
    return _out_proj(p, out), cache


def gqa_decode(p: ParamTree, cfg: ModelConfig, x: Tensor, cache: KVCache,
               cur_pos: int, *, window: int,
               layout: Optional[CacheLayout] = None
               ) -> Tuple[Tensor, KVCache]:
    """One-token decode.  x (B,1,D); cur_pos a Python int.  Writes the new
    K/V into ``cache`` in place (on the rank that owns its slot, when
    ``layout`` splits the slots) and returns it."""
    b, hd = x.shape[0], cfg.resolved_head_dim
    ctx = p.ctx
    pos1 = torch.tensor([cur_pos], dtype=torch.int32, device=x.device)
    q = torch.einsum("bsd,dhk->bshk", _split_input(p, x), p.w_q)
    q = apply_rope(q, pos1[None], cfg.rope_theta)
    k_new, v_new = _cache_kv(p, cfg, x, pos1,
                             cache.k.shape[2] == cfg.n_kv_heads)

    slot = _slot(layout, cur_pos, cache.k.shape[1])
    if slot is not None:
        cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
        cache.pos[slot] = cur_pos

    seq_axes = None if layout is None else layout.seq_axes
    meet = _heads_meet_slots(p, "w_q", 1, layout)
    if meet is not None:        # every head over this rank's slots
        lo, hi = held(p, "w_q", 1)
        q = collectives.all_gather(q, ctx, meet, dim=2)
        ck, cv = cache.k, cache.v
    else:
        glo, ghi = _group_kv(p, cfg, cache.k.shape[2])
        ck, cv = cache.k[:, :, glo:ghi], cache.v[:, :, glo:ghi]
    h, kv = q.shape[2], ck.shape[2]
    qg = q.reshape(b, kv, h // kv, hd)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.float(), ck.float())
    scores = scores / math.sqrt(hd)
    cpos = cache.pos
    valid = (cpos >= 0) & (cpos <= cur_pos) & ((cur_pos - cpos) < window)
    scores = torch.where(valid[None, None, None], scores,
                         torch.tensor(NEG_INF, device=x.device))
    probs = _probs(scores, ctx, seq_axes)
    o = _sum_slots(torch.einsum("bkgt,btkd->bkgd", probs.to(cv.dtype), cv),
                   ctx, seq_axes).reshape(b, 1, h, hd)
    if meet is not None:
        o = o[:, :, lo:hi]
    return _out_proj(p, o), cache


# ---------------------------------------------------------------------------
# Cross-attention (llama-3.2-vision's image layers, whisper's decoder).
# ---------------------------------------------------------------------------

class CrossCache(NamedTuple):
    k: Tensor   # (B, Tf, Kv, Dh): projected frontend keys (static a request)
    v: Tensor


def init_cross_cache(cfg: ModelConfig, batch: int, frontend_len: int,
                     device: torch.device,
                     n_kv: Optional[int] = None) -> CrossCache:
    """An empty cross cache of ``n_kv`` kv heads (default: all)."""
    shape = (batch, frontend_len, n_kv or cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return CrossCache(k=torch.zeros(shape, dtype=cfg.cdtype, device=device),
                      v=torch.zeros(shape, dtype=cfg.cdtype, device=device))


def cross_kv(p: ParamTree, cfg: ModelConfig, frontend: Tensor,
             whole: bool = False) -> CrossCache:
    """The frontend's K / V over this rank's kv heads, or every kv head
    when ``whole`` (a cross cache whose spec leaves them whole)."""
    if whole:
        return CrossCache(*_cache_kv(p, cfg, frontend, None, True))
    w_k, w_v = _kv_weights(p, cfg)
    frontend = _split_input(p, frontend)
    k = torch.einsum("btd,dhk->bthk", frontend, w_k)
    v = torch.einsum("btd,dhk->bthk", frontend, w_v)
    return CrossCache(k=k, v=v)


def cross_forward(p: ParamTree, cfg: ModelConfig, x: Tensor,
                  kv_cache: CrossCache, *, gated: bool = True,
                  impl: Optional[str] = None) -> Tensor:
    """x (B,S,D) attends over the precomputed frontend K/V, no causality
    (JAX: ``mha_full`` with zero positions, every key valid).  ``impl``
    None runs ``mha_full`` (training, and decode's S = 1); a backend name
    runs the flash op, non-causal (prefill).  ``tanh(gate)`` scales the
    output when ``gated``.  A cache of every kv head is read at the rank's
    q-head groups' ones."""
    q = torch.einsum("bsd,dhk->bshk", _split_input(p, x), p.w_q)
    ck, cv = kv_cache.k, kv_cache.v
    if ck.shape[2] == cfg.n_kv_heads:
        klo, khi = local_kv_heads(p, cfg)
        ck, cv = ck[:, :, klo:khi], cv[:, :, klo:khi]
    if impl is None:
        s, t = q.shape[1], ck.shape[1]
        out = mha_full(q, ck, cv,
                       torch.zeros(s, dtype=torch.int32, device=x.device),
                       torch.zeros(t, dtype=torch.int32, device=x.device),
                       window=GLOBAL_WINDOW, causal=False)
    else:
        out = flash_attention(q, ck, cv, causal=False,
                              window=GLOBAL_WINDOW, impl=impl)
    out = _out_proj(p, out)
    if gated:
        out = torch.tanh(p.gate.to(out.dtype)) * out
    return out


# ---------------------------------------------------------------------------
# MLA (deepseek-v3): compressed KV; absorbed decode.
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    c_kv: Tensor     # (B, C, r_kv)
    k_rope: Tensor   # (B, C, qk_rope)
    pos: Tensor      # (C,) int32, -1 = empty


def init_mla_cache(cfg: ModelConfig, batch: int, cache_len: int,
                   device: torch.device, dtype=None) -> MLACache:
    dtype = dtype or cfg.cdtype
    return MLACache(
        c_kv=torch.zeros((batch, cache_len, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, cache_len, cfg.qk_rope_dim), dtype=dtype,
                           device=device),
        pos=torch.full((cache_len,), -1, dtype=torch.int32, device=device),
    )


def _mla_q(p: ParamTree, cfg: ModelConfig, x: Tensor, positions: Tensor
           ) -> Tuple[Tensor, Tensor]:
    """q_nope (B,S,H,qk_nope), q_rope (B,S,H,qk_rope) (roped) of this
    rank's heads.  On a mesh x @ w_dq gives the rank's q_lora slice, its
    RMS taken over the whole q_lora width (the sums of squares summed over
    the axis), then ``w_uq``'s contraction over the slices is summed into
    every head's q, of which the rank keeps its own."""
    ctx = p.ctx
    lora_axes = axes(p, "w_dq", 1)
    cq = collectives.to_split(x, ctx, lora_axes) @ p.w_dq
    if lora_axes is None:
        cq = _rms(cq, p.q_norm)
    else:
        cf = cq.float()
        var = collectives.psum(torch.sum(cf * cf, dim=-1, keepdim=True),
                               ctx, lora_axes, grad="psum") / (
            cf.shape[-1] * ctx.size(lora_axes))
        cq = (cf * torch.rsqrt(var + 1e-6) * p.q_norm.float()).to(cq.dtype)
    q = collectives.psum_product(
        lambda a, b: torch.einsum("bsr,rhk->bshk", a, b), cq, p.w_uq, ctx,
        axes(p, "w_uq", 0))
    lo, hi = held(p, "w_uk", 1)      # the heads of w_uk / w_uv / w_o
    q = collectives.to_split(q, ctx, axes(p, "w_uk", 1))[:, :, lo:hi]
    q_nope, q_rope = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions[None], cfg.rope_theta)


def _mla_ckv(p: ParamTree, cfg: ModelConfig, x: Tensor, positions: Tensor
             ) -> Tuple[Tensor, Tensor]:
    """c_kv (B,S,r) (normed), k_rope (B,S,qk_rope) (roped, shared by the
    heads): whole on every rank of a mesh."""
    c_kv, k_rope = (x @ p.w_dkv).split([cfg.kv_lora_rank, cfg.qk_rope_dim],
                                       dim=-1)
    c_kv = _rms(c_kv, p.kv_norm)
    k_rope = apply_rope(k_rope[:, :, None, :], positions[None],
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_attend(p: ParamTree, cfg: ModelConfig, x: Tensor,
                positions: Tensor, q_chunk: int):
    """The expanded form over this rank's heads: K/V per head from c_kv,
    then causal ``mha_full`` (qk head dim nope + rope, v head dim
    v_head_dim).  Returns (out (B,S,D), c_kv, k_rope)."""
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_ckv(p, cfg, x, positions)
    over = axes(p, "w_uk", 1)
    c_in = collectives.to_split(c_kv, p.ctx, over)
    r_in = collectives.to_split(k_rope, p.ctx, over)
    k_nope = torch.einsum("bsr,rhk->bshk", c_in, p.w_uk)
    v = torch.einsum("bsr,rhv->bshv", c_in, p.w_uv)
    k = torch.cat([k_nope, r_in[:, :, None, :].expand(
        k_nope.shape[:3] + (cfg.qk_rope_dim,))], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = mha_full(q, k, v, positions, positions, window=GLOBAL_WINDOW,
                   causal=True, q_chunk=q_chunk)
    return _out_proj(p, out), c_kv, k_rope


def mla_forward(p: ParamTree, cfg: ModelConfig, x: Tensor,
                positions: Tensor, *, q_chunk: int = 512) -> Tensor:
    """Full-sequence MLA, no cache (training; differentiable)."""
    return _mla_attend(p, cfg, x, positions, q_chunk)[0]


def mla_prefill(p: ParamTree, cfg: ModelConfig, x: Tensor,
                positions: Tensor, *, cache_len: int, q_chunk: int = 512,
                layout: Optional[CacheLayout] = None
                ) -> Tuple[Tensor, MLACache]:
    """Full-sequence MLA and the compressed cache it leaves: the last
    ``cache_len`` tokens in order when S >= cache_len (JAX lays them out
    so, not by slot), else the S tokens padded with position -1; this
    rank's ``layout`` slots of it on a mesh."""
    out, c_kv, k_rope = _mla_attend(p, cfg, x, positions, q_chunk)
    s, dtype = x.shape[1], cfg.cdtype
    if s >= cache_len:
        cache = MLACache(c_kv=c_kv[:, -cache_len:].to(dtype),
                         k_rope=k_rope[:, -cache_len:].to(dtype),
                         pos=positions[-cache_len:].to(torch.int32))
    else:
        pad = cache_len - s

        def padded(t):
            return torch.cat([t.to(dtype), t.new_zeros(
                (t.shape[0], pad, t.shape[2]), dtype=dtype)], dim=1)

        cache = MLACache(c_kv=padded(c_kv), k_rope=padded(k_rope),
                         pos=torch.cat([positions.to(torch.int32),
                                        positions.new_full(
                                            (pad,), -1, dtype=torch.int32)]))
    if layout is not None:
        cache = MLACache(layout.own(cache.c_kv), layout.own(cache.k_rope),
                         layout.own(cache.pos, dim=0))
    return out, cache


def mla_decode(p: ParamTree, cfg: ModelConfig, x: Tensor, cache: MLACache,
               cur_pos: int, layout: Optional[CacheLayout] = None
               ) -> Tuple[Tensor, MLACache]:
    """One-token decode in the absorbed form: W_UK folded into the query,
    scores and context taken in c_kv space, scaled by 1 / sqrt(qk_nope +
    qk_rope).  x (B,1,D); cur_pos a Python int.  Writes the new token
    into ``cache`` in place (on the rank that owns its slot, when
    ``layout`` splits the slots) and returns it."""
    ctx = p.ctx
    pos1 = torch.tensor([cur_pos], dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, pos1)                # (B,1,H,*)
    c_new, r_new = _mla_ckv(p, cfg, x, pos1)                # (B,1,r), (B,1,p)

    slot = _slot(layout, cur_pos, cache.c_kv.shape[1])
    if slot is not None:
        cache.c_kv[:, slot] = c_new[:, 0].to(cache.c_kv.dtype)
        cache.k_rope[:, slot] = r_new[:, 0].to(cache.k_rope.dtype)
        cache.pos[slot] = cur_pos

    seq_axes = None if layout is None else layout.seq_axes
    q_eff = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p.w_uk)
    q_rope = q_rope[:, 0]
    meet = _heads_meet_slots(p, "w_uk", 1, layout)
    if meet is not None:        # every head over this rank's slots
        lo, hi = held(p, "w_uk", 1)
        q_eff = collectives.all_gather(q_eff, ctx, meet, dim=1)
        q_rope = collectives.all_gather(q_rope, ctx, meet, dim=1)
    scores = (torch.einsum("bhr,btr->bht", q_eff.float(), cache.c_kv.float())
              + torch.einsum("bhp,btp->bht", q_rope.float(),
                             cache.k_rope.float()))
    scores = scores / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    cpos = cache.pos
    valid = (cpos >= 0) & (cpos <= cur_pos)
    scores = torch.where(valid[None, None], scores,
                         torch.tensor(NEG_INF, device=x.device))
    probs = _probs(scores, ctx, seq_axes)
    ctx_c = _sum_slots(torch.einsum("bht,btr->bhr",
                                    probs.to(cache.c_kv.dtype), cache.c_kv),
                       ctx, seq_axes)
    if meet is not None:
        ctx_c = ctx_c[:, lo:hi]
    o = torch.einsum("bhr,rhv->bhv", ctx_c, p.w_uv)
    return _out_proj(p, o[:, None]), cache
