"""Losses for dual-coefficient kernel machines (port of
``repro/core/losses.py``).

Every loss exposes what the doubly stochastic update needs:

* ``value(f, y)``  — per-sample loss given the decision value f(x_i),
* ``grad_f(f, y)`` — (sub)gradient d loss / d f per sample.

The dual gradient of the paper (Alg. 1) factorizes as
``g_J = K_{I,J}^T grad_f(f_I, y_I) + lam * alpha_J`` with
``f_I = K_{I,J} alpha_J``.  ``LOSS_CODES`` numbers the losses as the CUDA
train passes' loss epilogues do (``kernels/dsekl/csrc/dsekl_tile.cuh``,
enum ``Loss``).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

Tensor = torch.Tensor


class Loss(NamedTuple):
    value: Callable[[Tensor, Tensor], Tensor]
    grad_f: Callable[[Tensor, Tensor], Tensor]
    # True if labels live in {-1, +1} (classification losses).
    binary_labels: bool


def _hinge_value(f: Tensor, y: Tensor) -> Tensor:
    return torch.clamp_min(1.0 - y * f, 0.0)


def _hinge_grad(f: Tensor, y: Tensor) -> Tensor:
    # Strict <: at y*f == 1 exactly the subgradient is 0.
    return torch.where(y * f < 1.0, -y, torch.zeros_like(y))


def _sq_hinge_value(f: Tensor, y: Tensor) -> Tensor:
    m = torch.clamp_min(1.0 - y * f, 0.0)
    return m * m


def _sq_hinge_grad(f: Tensor, y: Tensor) -> Tensor:
    return -2.0 * y * torch.clamp_min(1.0 - y * f, 0.0)


def _square_value(f: Tensor, y: Tensor) -> Tensor:
    return 0.5 * (f - y) ** 2


def _square_grad(f: Tensor, y: Tensor) -> Tensor:
    return f - y


def _logistic_value(f: Tensor, y: Tensor) -> Tensor:
    # log(1 + exp(-y f)), numerically stable (jnp.logaddexp(0, -y f)).
    return torch.logaddexp(torch.zeros_like(f), -y * f)


def _logistic_grad(f: Tensor, y: Tensor) -> Tensor:
    return -y * torch.sigmoid(-y * f)


LOSSES: Dict[str, Loss] = {
    "hinge": Loss(_hinge_value, _hinge_grad, True),           # paper Eq. 4 (SVM)
    "squared_hinge": Loss(_sq_hinge_value, _sq_hinge_grad, True),
    "square": Loss(_square_value, _square_grad, False),       # kernel ridge
    "logistic": Loss(_logistic_value, _logistic_grad, True),
}

LOSS_CODES: Dict[str, int] = {name: i for i, name in enumerate(LOSSES)}


def get_loss(name: str) -> Loss:
    if name not in LOSSES:
        raise ValueError(f"unknown loss {name!r}; available: {sorted(LOSSES)}")
    return LOSSES[name]
