"""Mixture-of-experts FFN on one device (port of the unsharded branch of
``repro/models/moe.py``, ``ctx.mesh is None``).

Dispatch is sort-free: a cumsum over a (slots, E) one-hot builds the
(E, capacity) token table, and tokens past an expert's capacity are dropped
(standard capacity-factor semantics).  Each expert's batch is gathered,
run through its gated FFN as one batched product, and scattered back with
its router weight.  Autograd flows through the dispatch (the gather, the
router weights in the prob table, the scatter-add) with drops: a dropped
choice lands in the trash slot and gets no gradient.  ``moe_forward(...,
with_aux=True)`` also returns the Switch-style load-balance loss
(``load_balance_loss``) for training.  The expert-parallel collectives of
the JAX module come with the mesh (ROADMAP.md section 1, item 6).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.nn.module import Param, ParamTree

Tensor = torch.Tensor


def moe_specs(cfg: ModelConfig) -> Dict[str, Param]:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    specs = {
        "router": Param((d, e), init="fan_in"),
        "w_gate": Param((e, d, f), init="fan_in"),
        "w_up": Param((e, d, f), init="fan_in"),
        "w_down": Param((e, f, d), init="fan_in"),
    }
    if cfg.n_shared_experts:
        specs["shared"] = layers.mlp_specs(
            cfg, cfg.moe_d_ff * cfg.n_shared_experts)
    return specs


def _dispatch_tables(top_ids: Tensor, top_probs: Tensor, e_start: int,
                     e_loc: int, capacity: int, n_tokens: int
                     ) -> Tuple[Tensor, Tensor]:
    """(E_loc, C) token-index and prob tables for the local experts; empty
    slots hold token ``n_tokens`` (a zero row) with prob 0.

    The slot of each (token, choice) in its expert is a running count in
    int32, as in JAX, scanned along the contiguous axis of the (E_loc,
    T*k) one-hot.  Dropped choices (another expert's, or past the
    capacity) are written to one trash slot past the table, so the tables
    are built without a boolean mask (no host synchronisation)."""
    k = top_ids.shape[-1]
    dev = top_ids.device
    flat_e = top_ids.reshape(-1)                                 # (T*k,)
    flat_t = torch.arange(n_tokens, dtype=torch.int64,
                          device=dev).repeat_interleave(k)
    flat_p = top_probs.reshape(-1)
    local = (flat_e >= e_start) & (flat_e < e_start + e_loc)
    le = torch.where(local, flat_e - e_start, e_loc)             # trash bucket
    onehot = le[None, :] == torch.arange(e_loc, device=dev)[:, None]
    pos = torch.cumsum(onehot.to(torch.int32), dim=1, dtype=torch.int32) - 1
    pos = torch.sum(pos * onehot, dim=0, dtype=torch.int32)      # slot in expert
    keep = local & (pos < capacity)                              # drop overflow
    slot = torch.where(keep, le * capacity + pos, e_loc * capacity)
    table = torch.full((e_loc * capacity + 1,), n_tokens, dtype=torch.int64,
                       device=dev)
    table[slot] = flat_t
    ptable = torch.zeros((e_loc * capacity + 1,), dtype=flat_p.dtype,
                         device=dev)
    ptable[slot] = flat_p
    return (table[:-1].view(e_loc, capacity),
            ptable[:-1].view(e_loc, capacity))


def _moe_inner(xt: Tensor, top_ids: Tensor, top_probs: Tensor,
               w_gate: Tensor, w_up: Tensor, w_down: Tensor, e_loc: int,
               capacity: int) -> Tensor:
    """xt (T, D) tokens; weights (E, D, F) / (E, F, D)."""
    t, d = xt.shape
    table, ptable = _dispatch_tables(top_ids, top_probs, 0, e_loc, capacity,
                                     t)
    x_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    xg = x_pad[table]                                            # (E, C, D)
    h = F.silu(torch.bmm(xg, w_gate)) * torch.bmm(xg, w_up)      # (E, C, F)
    yg = torch.bmm(h, w_down)                                    # (E, C, D)
    y = xt.new_zeros((t + 1, d), dtype=yg.dtype)
    y.index_add_(0, table.reshape(-1),
                 (yg * ptable[..., None].to(yg.dtype)).reshape(-1, d))
    return y[:t]


def load_balance_loss(probs: Tensor, top_ids: Tensor, n_experts: int
                      ) -> Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e (f_e = routed-token
    fraction over the top-k assignments, p_e = mean router prob).
    Minimized (= 1) by a uniform router."""
    f = torch.mean(F.one_hot(top_ids.long(), n_experts).to(torch.float32),
                   dim=(0, 1))
    p = torch.mean(probs, dim=0)
    return n_experts * torch.sum(f * p)


def moe_forward(p: ParamTree, cfg: ModelConfig, x: Tensor,
                with_aux: bool = False):
    """x (B, S, D) -> (B, S, D) [, aux load-balance loss].  Router in f32;
    top-k renormalized."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = xt.to(torch.float32) @ p.router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_probs, top_ids = torch.topk(probs, cfg.top_k, dim=-1)
    top_probs = top_probs / torch.sum(top_probs, dim=-1, keepdim=True)
    top_probs = top_probs.to(x.dtype)
    aux = (load_balance_loss(probs, top_ids, cfg.n_experts)
           if with_aux else None)
    cap = max(1, math.ceil(b * s * cfg.top_k * cfg.capacity_factor
                           / cfg.n_experts))
    y = _moe_inner(xt, top_ids, top_probs, p.w_gate, p.w_up, p.w_down,
                   cfg.n_experts, cap).reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + layers.mlp(p.shared, cfg, x)
    return (y, aux) if with_aux else y
