"""The LM training step: autograd loss and gradients, then the optimizer
(port of ``repro/train/step.py``).

No kernel has a backward (JAX trains through XLA too), so the loss runs
the model's plain differentiable functions and ``torch.autograd`` takes
the gradients; remat lives in the model stack.

On a mesh (a model built with ``ctx=MeshCtx.for_mesh(mesh, "train")``)
every rank runs the step on the whole batch it is given, of which the
model takes its data shard (JAX's ``batch_shardings``: batch over data).
Each rank's loss is the mean over its shard; the step's loss is the mean
of those over the data axes.  Autograd runs through the collectives'
adjoints (``distributed/collectives.py``), so that a gradient is whole
over the model axis and each rank's share over the data axes: the
parameters replicated over the data axes then have their gradients
summed over them (one all-reduce of all of them, in float32), those
split over the data axes (ZeRO's "embed" dims, the experts' FFN dim)
were summed by their gathers' backward, and every gradient is divided by
the number of data shards.  The optimizer needs the mesh layout for its
global norm: ``make_optimizer(..., shards=param_shards(model))``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import as_axes
from repro_torch.models.model import LanguageModel
from repro_torch.nn.module import ParamTree, split_entries
from repro_torch.optim import Optimizer, Shards, global_norm

Tensor = torch.Tensor


def trainable(model: LanguageModel) -> Dict[str, torch.nn.Parameter]:
    """The model's parameters by ``state_dict`` name, made trainable
    (the port creates them without gradients, for serving)."""
    model.requires_grad_(True)
    return dict(model.named_parameters())


def param_shards(model: LanguageModel) -> Shards:
    """The model's mesh layout: its ``MeshCtx`` (None off a mesh) and the
    ``Param`` spec of each parameter by ``state_dict`` name."""
    specs = {}
    for prefix, tree in model.named_modules():
        if isinstance(tree, ParamTree):
            for name, spec in tree.specs.items():
                specs[f"{prefix}.{name}" if prefix else name] = spec
    return Shards(ctx=model.ctx if model.sharded else None, specs=specs)


def _data_split(shards: Shards, name: str) -> bool:
    """Whether an axis of the batch splits parameter ``name``."""
    ctx = shards.ctx
    return any(a in ctx.batch_axes for e in split_entries(
        shards.specs[name], ctx) for a in as_axes(e))


def finish_grads(grads: Dict[str, Tensor], shards: Shards
                 ) -> Dict[str, Tensor]:
    """A rank's gradients (its shard's share over the data axes) as the
    step's: those of parameters replicated over the data axes summed over
    them (flattened into one float32 all-reduce), then every one divided
    by the number of data shards, in its own dtype."""
    ctx = shards.ctx
    n = ctx.n_batch
    if n == 1:
        return grads
    rep = [k for k in grads if not _data_split(shards, k)]
    out = {k: g.float() for k, g in grads.items()}
    if rep:
        flat = torch.cat([out[k].reshape(-1) for k in rep])
        flat = collectives.psum(flat, ctx, ctx.batch_axes)
        for k, piece in zip(rep, flat.split([out[k].numel() for k in rep])):
            out[k] = piece.view(out[k].shape)
    return {k: (out[k] / n).to(g.dtype) for k, g in grads.items()}


def make_train_step(model: LanguageModel, optimizer: Optimizer, *,
                    loss_chunks: int = 8, remat: bool = True,
                    microbatches: int = 1) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.

    ``params`` is ``trainable(model)``: the model's own parameters, which
    the step overwrites in place with the optimizer's new values (and
    returns).  ``batch = {"tokens": (B,S), "labels": (B,S)}`` integer
    tensors on the model's device (on a mesh, the whole batch on every
    rank).  With ``microbatches > 1`` the gradients of B / microbatches
    slices accumulate in float32 and are divided at the end, as JAX's scan
    does.  ``metrics`` holds the loss and ``grad_norm``, the norm of the
    unclipped gradients (the optimizer clips inside ``update``), as 0-d
    device tensors."""
    shards = param_shards(model)
    if shards.ctx is not None and (optimizer.shards is None
                                   or optimizer.shards.ctx is None):
        raise ValueError(
            f"{model.cfg.name} is sharded over a mesh of "
            f"{shards.ctx.n_data} x {shards.ctx.n_model} ranks: build the "
            "optimizer with make_optimizer(..., shards=param_shards(model)) "
            "so that its global norm spans the mesh")

    def loss_and_grads(params, tokens, labels, frontend):
        loss = model.loss(tokens, labels, frontend=frontend,
                          loss_chunks=loss_chunks, remat=remat)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), dict(zip(params, grads))

    def train_step(params: Dict[str, Tensor], opt_state: dict,
                   batch: Dict[str, Tensor]) -> Tuple[dict, dict, dict]:
        tokens, labels = batch["tokens"], batch["labels"]
        frontend = batch.get("frontend")
        if microbatches == 1:
            loss, grads = loss_and_grads(params, tokens, labels, frontend)
        else:
            mb = tokens.shape[0] // microbatches
            loss = tokens.new_zeros((), dtype=torch.float32)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            for i in range(microbatches):
                sl = slice(i * mb, (i + 1) * mb)
                fe = frontend[sl] if frontend is not None else None
                l, g = loss_and_grads(params, tokens[sl], labels[sl], fe)
                grads = {k: grads[k] + g[k] for k in grads}
                loss = loss + l
            loss = loss / microbatches
            grads = {k: g / microbatches for k, g in grads.items()}
        if shards.ctx is not None:
            ctx = shards.ctx
            grads = finish_grads(grads, shards)
            loss = collectives.psum(loss.clone(), ctx,
                                    ctx.batch_axes) / ctx.n_batch
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        metrics = {"loss": loss,
                   "grad_norm": global_norm(grads, optimizer.shards)}
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_params[k])
        return params, new_opt, metrics

    return train_step
