"""The LM training step: autograd loss and gradients, then the optimizer
(port of ``repro/train/step.py``).

No kernel has a backward (JAX trains through XLA too), so the loss runs
the model's plain differentiable functions and ``torch.autograd`` takes
the gradients; remat lives in the model stack.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.models.model import LanguageModel
from repro_torch.optim import Optimizer, global_norm

Tensor = torch.Tensor


def trainable(model: LanguageModel) -> Dict[str, torch.nn.Parameter]:
    """The model's parameters by ``state_dict`` name, made trainable
    (the port creates them without gradients, for serving)."""
    model.requires_grad_(True)
    return dict(model.named_parameters())


def make_train_step(model: LanguageModel, optimizer: Optimizer, *,
                    loss_chunks: int = 8, remat: bool = True,
                    microbatches: int = 1) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.

    ``params`` is ``trainable(model)``: the model's own parameters, which
    the step overwrites in place with the optimizer's new values (and
    returns).  ``batch = {"tokens": (B,S), "labels": (B,S)}`` integer
    tensors on the model's device.  With ``microbatches > 1`` the
    gradients of B / microbatches slices accumulate in float32 and are
    divided at the end, as JAX's scan does.  ``metrics`` holds the loss
    and ``grad_norm``, the norm of the unclipped gradients (the optimizer
    clips inside ``update``), as 0-d device tensors."""

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
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_params[k])
        return params, new_opt, metrics

    return train_step
