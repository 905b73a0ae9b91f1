"""SGD / momentum / AdaGrad (paper Alg. 2) / AdamW over a model's
parameters (port of ``repro/optim/optimizers.py``).

``params`` and ``grads`` are mappings name -> tensor (a model's
``named_parameters``); the optimizer state mirrors them leaf by leaf
(``{"count", "m", "v"}`` / ``"g2"``), so a checkpoint flattens it beside
the parameters.  ``update(grads, state, params) -> (new_params,
new_state)`` is functional, as in JAX.

Written out rather than taken from ``torch.optim``, which is another
function in three places:

  * AdaGrad's accumulator starts at 1 (paper Alg. 2 line 4), not at 0;
  * AdamW adds ``weight_decay * p`` inside the update, where
    ``torch.optim.AdamW`` decays ``p`` before the step;
  * every update is taken in float32 and the new parameter cast back to
    its own dtype: with bfloat16 parameters that cast is part of the
    function.

The step count and the learning rate are 0-d CPU tensors (the schedule's
float32 arithmetic, ``schedules.py``): the device never waits for them.

On a mesh (``shards``: the ``MeshCtx`` and each parameter's spec,
``train.param_shards``) every update stays elementwise on the rank's
local slices; only the global norm (clipping, and the step's
``grad_norm``) reaches across ranks: each parameter's local sum of
squares is summed over the mesh axes that split it, never over those it
is replicated on (JAX's GSPMD takes the same norm of the global arrays).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.nn.module import norm_parts

Tensor = torch.Tensor
Tree = Dict[str, Tensor]
NAMES = ("sgd", "momentum", "adagrad", "adamw")


class Shards(NamedTuple):
    """A mesh's layout of a parameter tree: the ``MeshCtx`` and each
    parameter's ``Param`` spec by name."""
    ctx: Any
    specs: Mapping[str, Any]


class Optimizer(NamedTuple):
    init: Callable[[Mapping[str, Tensor]], dict]
    update: Callable[[Mapping[str, Tensor], dict, Mapping[str, Tensor]],
                     Tuple[Tree, dict]]
    shards: Optional[Shards] = None


def global_norm(tree: Mapping[str, Tensor],
                shards: Optional[Shards] = None) -> Tensor:
    """sqrt of the sum over leaves (in order) of sum(x ** 2) in float32.
    With ``shards`` the leaves are a rank's slices: the sums are grouped
    by the mesh axes that split them, each group summed over those axes
    (module docstring), then added in a fixed order."""
    if shards is None or shards.ctx is None or not shards.ctx.sharded:
        total = None
        for x in tree.values():
            s = torch.sum(torch.square(x.float()))
            total = s if total is None else total + s
        return torch.sqrt(total)
    groups: Dict[Tuple, Tensor] = {}
    for k, x in tree.items():
        for entries, part in norm_parts(x, shards.specs[k], shards.ctx):
            s = torch.sum(torch.square(part.float()))
            groups[entries] = s if entries not in groups \
                else groups[entries] + s
    total = None
    for entries in sorted(groups, key=repr):
        s = groups[entries].detach().clone()
        for entry in entries:
            s = collectives.psum(s, shards.ctx, entry)
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree: Mapping[str, Tensor], max_norm: float,
                        shards: Optional[Shards] = None) -> Tree:
    norm = global_norm(tree, shards)
    # torch.div of two tensors: ``float / tensor`` is a reciprocal times
    # the float in torch, which rounds differently.
    scale = torch.clamp(torch.div(torch.full_like(norm, max_norm),
                                  norm + 1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in tree.items()}


def make_optimizer(name: str, schedule: Callable, *, b1: float = 0.9,
                   b2: float = 0.95, eps: float = 1e-8,
                   weight_decay: float = 0.0, momentum: float = 0.9,
                   moment_dtype: torch.dtype = torch.float32,
                   grad_clip: Optional[float] = 1.0,
                   shards: Optional[Shards] = None) -> Optimizer:
    """name: sgd | momentum | adagrad | adamw.  ``shards``: the mesh
    layout of the parameters (``train.param_shards(model)``) when they
    are a rank's slices."""
    if name not in NAMES:
        raise ValueError(f"unknown optimizer {name!r}")
    f32 = torch.float32

    def init(params: Mapping[str, Tensor]) -> dict:
        def filled(value):
            return {k: torch.full(p.shape, value, dtype=moment_dtype,
                                  device=p.device)
                    for k, p in params.items()}

        state = {"count": torch.zeros((), dtype=torch.int32)}
        if name == "momentum":
            state["m"] = filled(0.0)
        elif name == "adagrad":
            # Paper Alg. 2 line 4: G <- 1 (identity damping at t = 0).
            state["g2"] = filled(1.0)
        elif name == "adamw":
            state["m"] = filled(0.0)
            state["v"] = filled(0.0)
        return state

    def update(grads: Mapping[str, Tensor], state: dict,
               params: Mapping[str, Tensor]) -> Tuple[Tree, dict]:
        count = state["count"] + 1
        neg_lr = -schedule(count)
        if grad_clip is not None:
            grads = clip_by_global_norm(grads, grad_clip, shards)
        new_state = {"count": count}
        new_params: Tree = {}

        def put(k, upd):       # the new parameter, in its own dtype
            p = params[k]
            new_params[k] = (p.float() + upd).to(p.dtype)

        if name == "sgd":
            for k, g in grads.items():
                put(k, neg_lr * g.float())
        elif name == "momentum":
            new_state["m"] = {}
            for k, g in grads.items():
                mo = state["m"][k]
                m = momentum * mo.float() + g.float()
                new_state["m"][k] = m.to(mo.dtype)
                put(k, neg_lr * m)
        elif name == "adagrad":
            new_state["g2"] = {}
            for k, g in grads.items():
                acc = state["g2"][k]
                g2 = acc.float() + torch.square(g.float())
                new_state["g2"][k] = g2.to(acc.dtype)
                put(k, neg_lr * g.float() * torch.rsqrt(g2 + eps))
        else:
            c = count.to(f32)
            bc1 = 1 - torch.pow(torch.tensor(b1, dtype=f32), c)
            bc2 = 1 - torch.pow(torch.tensor(b2, dtype=f32), c)
            new_state["m"], new_state["v"] = {}, {}
            for k, g in grads.items():
                mo, vo = state["m"][k], state["v"][k]
                gf = g.float()
                m = b1 * mo.float() + (1 - b1) * gf
                v = b2 * vo.float() + (1 - b2) * torch.square(gf)
                new_state["m"][k] = m.to(mo.dtype)
                new_state["v"][k] = v.to(vo.dtype)
                put(k, neg_lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                                 + weight_decay * params[k].float()))
        return new_params, new_state

    return Optimizer(init=init, update=update, shards=shards)
