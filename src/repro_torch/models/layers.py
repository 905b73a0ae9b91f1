"""Shared layers: norms, gated MLP, embeddings, logits head (port of
``repro/models/layers.py``).

On a mesh each function reads its parameters' local slices (``p`` a
``ParamTree`` or its ``view()``, which carries the ``MeshCtx``): the MLP's
``w_gate`` / ``w_up`` split by columns and ``w_down`` by rows, its partial
products summed over the model axis in float32
(``collectives.psum_product``); the embedding looks up the rows of its
vocab slice (others give 0) and sums over the model axis; the logits head
gives this rank's vocab slice.  A dim the rules do not split (a vocab that
does not divide, as mamba2's 50,280 on 16) is whole and needs no sum.  In
training the MLP's input enters its split columns through
``collectives.to_split`` (its gradient summed over the model axis)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.nn.module import Param, ParamTree, axes, held

Tensor = torch.Tensor


# --- RMSNorm ---------------------------------------------------------------

def rmsnorm_specs(d: int) -> Dict[str, Param]:
    return {"scale": Param((d,), init="ones", logical=("embed",))}


def rmsnorm(p: ParamTree, x: Tensor, eps: float) -> Tensor:
    """Computed in f32, then cast to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p.scale.to(torch.float32)).to(x.dtype)


# --- Gated MLP (llama-style) / plain GELU MLP -------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: int) -> Dict[str, Param]:
    d = cfg.d_model
    if cfg.mlp_act == "silu":
        return {
            "w_gate": Param((d, d_ff), init="fan_in",
                            logical=("embed", "mlp")),
            "w_up": Param((d, d_ff), init="fan_in", logical=("embed", "mlp")),
            "w_down": Param((d_ff, d), init="fan_in",
                            logical=("mlp", "embed")),
        }
    return {
        "w_up": Param((d, d_ff), init="fan_in", logical=("embed", "mlp")),
        "w_down": Param((d_ff, d), init="fan_in", logical=("mlp", "embed")),
    }


def mlp(p: ParamTree, cfg: ModelConfig, x: Tensor) -> Tensor:
    x = collectives.to_split(x, p.ctx, axes(p, "w_up", 1))
    if cfg.mlp_act == "silu":
        h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    else:
        # jax.nn.gelu defaults to the tanh approximation; torch to erf.
        h = F.gelu(x @ p.w_up, approximate="tanh")
    return collectives.psum_product(torch.matmul, h, p.w_down, p.ctx,
                                    axes(p, "w_down", 0))


# --- Embedding / logits ------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> Dict[str, Param]:
    return {"table": Param((cfg.vocab_size, cfg.d_model), init="embed",
                           scale=0.02, logical=("vocab", "embed"))}


def embed(p: ParamTree, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    vocab_axes = axes(p, "table", 0)
    if vocab_axes is None:
        return p.table[tokens].to(cfg.cdtype)
    # Vocab-parallel: the rows of this rank's slice, 0 elsewhere, summed
    # over the slice's axes (one nonzero term: exact).
    lo, hi = held(p, "table", 0)
    ids = tokens - lo
    mine = (ids >= 0) & (ids < hi - lo)
    rows = p.table[torch.where(mine, ids, 0)]
    rows = torch.where(mine[..., None], rows, rows.new_zeros(()))
    return collectives.psum(rows, p.ctx, vocab_axes).to(cfg.cdtype)


def head_specs(cfg: ModelConfig) -> Dict[str, Param]:
    return {"w_out": Param((cfg.d_model, cfg.vocab_size), init="fan_in",
                           logical=("embed", "vocab"))}


def logits_head(p: ParamTree, x: Tensor) -> Tensor:
    """The logits of this rank's vocab slice (all of them off a mesh)."""
    return x @ p.w_out
