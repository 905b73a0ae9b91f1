"""Mixture-of-experts FFN (port of ``repro/models/moe.py``: the unsharded
branch, ``ctx.mesh is None``, and the expert-parallel one).

Dispatch is sort-free: a cumsum over a (slots, E) one-hot builds the
(E, capacity) token table, and tokens past an expert's capacity are dropped
(standard capacity-factor semantics).  Each expert's batch is gathered,
run through its gated FFN as one batched product, and scattered back with
its router weight.  Autograd flows through the dispatch (the gather, the
router weights in the prob table, the scatter-add) with drops: a dropped
choice lands in the trash slot and gets no gradient.  ``moe_forward(...,
with_aux=True)`` also returns the Switch-style load-balance loss
(``load_balance_loss``) for training.

On a mesh (``_moe_mesh``, JAX's ``shard_map`` body) the experts are split
over the model axis (E_loc = E / |model|, this rank's from ``e_start = m *
E_loc``) and each expert's FFN dim over the data axes (``expert_mlp``).
The tokens are the rank's data shard (``moe_tokens``; when the batch did
not divide, the whole batch is on every rank and each takes its 1/n of
the tokens, the outputs gathered back), with the capacity computed from
the shard's token count, as JAX's.  Per layer: the expert batches are
gathered over the data axes, the F-partial outputs (float32, as
``collectives.psum_product``'s) summed back by a psum-scatter, and the
token outputs summed over the model axis in the activations' dtype (as
JAX's; a token's top-2 outputs round once either way).  The router is
gathered whole.

Training on a mesh: the tokens and their router weights enter the local
experts through ``collectives.to_split`` (their gradients summed over
the model axis), the router's gather gives each rank its slice of the
gradient back, and the data axes' gather and psum-scatter have their
adjoints (``collectives``).  The load-balance loss is JAX's, over the
GLOBAL tokens (JAX takes it outside its ``shard_map``): it is not linear
in the tokens, so the per-expert counts and router-probability sums are
summed over the data axes before the product, never each shard's loss
averaged.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.models import layers
from repro_torch.nn.module import Param, ParamTree, axes, held

Tensor = torch.Tensor


def moe_specs(cfg: ModelConfig) -> Dict[str, Param]:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    specs = {
        "router": Param((d, e), init="fan_in", logical=("embed", "experts")),
        # The expert D dims are unnamed (whole); the FFN dim carries
        # "expert_mlp" -> the data axes.
        "w_gate": Param((e, d, f), init="fan_in",
                        logical=("experts", None, "expert_mlp")),
        "w_up": Param((e, d, f), init="fan_in",
                      logical=("experts", None, "expert_mlp")),
        "w_down": Param((e, f, d), init="fan_in",
                        logical=("experts", "expert_mlp", None)),
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


def load_balance_loss(probs: Tensor, top_ids: Tensor, n_experts: int,
                      ctx=None, over=None) -> Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e (f_e = routed-token
    fraction over the top-k assignments, p_e = mean router prob).
    Minimized (= 1) by a uniform router.  With ``over`` (the data axes
    the tokens are split over) both means are over the tokens of every
    rank on those axes: the counts and sums are summed over them first."""
    onehot = F.one_hot(top_ids.long(), n_experts).to(torch.float32)
    if over is None:
        f = torch.mean(onehot, dim=(0, 1))
        p = torch.mean(probs, dim=0)
        return n_experts * torch.sum(f * p)
    t = float(probs.shape[0] * ctx.size(over))
    f = collectives.psum(torch.sum(onehot, dim=(0, 1)), ctx, over) / (
        t * top_ids.shape[-1])
    p = collectives.psum(torch.sum(probs, dim=0), ctx, over,
                         grad="psum") / t
    return n_experts * torch.sum(f * p)


def _moe_mesh(p: ParamTree, cfg: ModelConfig, xt: Tensor, top_ids: Tensor,
              top_probs: Tensor, batch_split: bool) -> Tensor:
    """The expert-parallel branch: xt (T, D) the rank's tokens (its data
    shard when ``batch_split``, else the whole batch) -> (T, D)."""
    ctx = p.ctx
    dp, model = tuple(ctx.data_axes), ctx.model_axis
    if ctx.n_model > 1 and axes(p, "w_gate", 0) is None:
        raise ValueError(f"{cfg.name}: {cfg.n_experts} experts do not split "
                         f"over a model axis of {ctx.n_model}")
    if ctx.n_data > 1 and axes(p, "w_gate", 2) is None:
        raise ValueError(f"{cfg.name}: the expert FFN dim {cfg.moe_d_ff} "
                         f"does not split over {ctx.n_data} data ranks")
    tokens_sharded = ctx.axis_rule("moe_tokens") is not None
    gather = tokens_sharded and ctx.n_data > 1
    t_all, d = xt.shape
    cut = gather and not batch_split
    if cut:
        # Tokens replicated over the data axes: this rank's 1/n of them.
        if t_all % ctx.n_data:
            raise ValueError(f"{t_all} tokens do not split over "
                             f"{ctx.n_data} data ranks")
        t_loc = t_all // ctx.n_data
        lo = ctx.index(dp) * t_loc
        xt, top_ids, top_probs = (t[lo:lo + t_loc]
                                  for t in (xt, top_ids, top_probs))
    t_loc = xt.shape[0]
    cap = max(1, math.ceil(t_loc * cfg.top_k * cfg.capacity_factor
                           / cfg.n_experts))
    e_start, e_stop = held(p, "w_gate", 0)
    e_loc = e_stop - e_start
    over = axes(p, "w_gate", 0)
    xt = collectives.to_split(xt, ctx, over)
    top_probs = collectives.to_split(top_probs, ctx, over)
    table, ptable = _dispatch_tables(top_ids, top_probs, e_start, e_loc, cap,
                                     t_loc)
    x_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    xg = x_pad[table]                                        # (E_loc, C, D)
    if gather:
        # Each expert batch meets every F shard: gathered over data.
        xg = collectives.all_gather(xg, ctx, dp, dim=1)
    h = F.silu(torch.bmm(xg, p.w_gate)) * torch.bmm(xg, p.w_up)
    if ctx.n_data > 1:
        # F-partials in float32, summed, rounded once.
        yf = torch.bmm(h.to(torch.float32), p.w_down.to(torch.float32))
        yf = (collectives.psum_scatter(yf, ctx, dp, dim=1) if tokens_sharded
              else collectives.psum(yf, ctx, dp, grad="psum"))
        yg = yf.to(h.dtype)
    else:
        yg = torch.bmm(h, p.w_down)
    y = xt.new_zeros((t_loc + 1, d), dtype=yg.dtype)
    y.index_add_(0, table.reshape(-1),
                 (yg * ptable[..., None].to(yg.dtype)).reshape(-1, d))
    y = collectives.psum(y[:t_loc], ctx, model)
    if cut:
        y = collectives.all_gather(y, ctx, dp, dim=0)
    return y


def whole_router(p: ParamTree) -> Tensor:
    """The (D, E) router, gathered over the axes that split its experts
    (every rank routes every token to all E experts)."""
    over = axes(p, "router", 1)
    if over is None:
        return p.router
    return collectives.all_gather(p.router, p.ctx, over, dim=1,
                                  grad="slice")


def moe_forward(p: ParamTree, cfg: ModelConfig, x: Tensor,
                with_aux: bool = False, batch_split: bool = False):
    """x (B, S, D) -> (B, S, D) [, aux load-balance loss].  Router in f32;
    top-k renormalized.  On a mesh (``p.ctx``) the expert-parallel branch;
    ``batch_split`` says x is the rank's data shard of the batch; the
    aux loss is then over the whole batch's tokens."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = xt.to(torch.float32) @ whole_router(p).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_probs, top_ids = torch.topk(probs, cfg.top_k, dim=-1)
    top_probs = top_probs / torch.sum(top_probs, dim=-1, keepdim=True)
    top_probs = top_probs.to(x.dtype)
    sharded = p.ctx is not None and p.ctx.sharded
    aux = None
    if with_aux:
        over = (tuple(p.ctx.data_axes) if sharded and batch_split
                else None)
        aux = load_balance_loss(probs, top_ids, cfg.n_experts, p.ctx, over)
    if sharded:
        y = _moe_mesh(p, cfg, xt, top_ids, top_probs,
                      batch_split).reshape(b, s, d)
    else:
        cap = max(1, math.ceil(b * s * cfg.top_k * cfg.capacity_factor
                               / cfg.n_experts))
        y = _moe_inner(xt, top_ids, top_probs, p.w_gate, p.w_up, p.w_down,
                       cfg.n_experts, cap).reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + layers.mlp(p.shared, cfg, x)
    return (y, aux) if with_aux else y
