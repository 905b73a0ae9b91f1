"""Classical kernel functions k(x, y) evaluated block-wise (port of
``repro/core/kernels_fn.py``).

Every function takes ``X (n, d)`` and ``Y (m, d)`` float tensors and
returns the kernel block ``K (n, m)``.  The arithmetic follows the JAX
registry step for step: the ``|x|^2 + |y|^2 - 2 x.y`` expansion clamped at
0, the ``+1e-12`` inside both Matérn kernels, and float32 constants.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict

import torch

Tensor = torch.Tensor

# jnp.sqrt(3.0) / jnp.sqrt(5.0) are float32 scalars; keep the same values.
SQRT3 = float(torch.tensor(3.0).sqrt())
SQRT5 = float(torch.tensor(5.0).sqrt())


def sq_dists(x: Tensor, y: Tensor) -> Tensor:
    """Pairwise squared Euclidean distances, (n, m), clamped at 0."""
    xx = torch.sum(x * x, dim=-1)[:, None]
    yy = torch.sum(y * y, dim=-1)[None, :]
    xy = x @ y.T
    return torch.clamp_min(xx + yy - 2.0 * xy, 0.0)


def integer_pow(t: Tensor, degree) -> Tensor:
    """``t ** degree`` as JAX evaluates it: an integral degree is
    repeated multiplication (``lax.integer_pow``, defined for negative
    bases), any other degree is ``pow``."""
    if float(degree).is_integer():
        return torch.pow(t, int(degree))
    return torch.pow(t, float(degree))


def rbf(x: Tensor, y: Tensor, *, gamma: float = 1.0) -> Tensor:
    """Gaussian RBF: exp(-gamma * ||x - y||^2)."""
    return torch.exp(-gamma * sq_dists(x, y))


def laplacian(x: Tensor, y: Tensor, *, gamma: float = 1.0) -> Tensor:
    """Laplacian: exp(-gamma * ||x - y||_1)."""
    d1 = torch.sum(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)
    return torch.exp(-gamma * d1)


def linear(x: Tensor, y: Tensor) -> Tensor:
    return x @ y.T


def polynomial(x: Tensor, y: Tensor, *, gamma: float = 1.0,
               coef0: float = 1.0, degree: int = 3) -> Tensor:
    return integer_pow(gamma * (x @ y.T) + coef0, degree)


def sigmoid(x: Tensor, y: Tensor, *, gamma: float = 1.0,
            coef0: float = 0.0) -> Tensor:
    return torch.tanh(gamma * (x @ y.T) + coef0)


def matern32(x: Tensor, y: Tensor, *, length_scale: float = 1.0) -> Tensor:
    d = torch.sqrt(sq_dists(x, y) + 1e-12) / length_scale
    z = SQRT3 * d
    return (1.0 + z) * torch.exp(-z)


def matern52(x: Tensor, y: Tensor, *, length_scale: float = 1.0) -> Tensor:
    d = torch.sqrt(sq_dists(x, y) + 1e-12) / length_scale
    z = SQRT5 * d
    return (1.0 + z + z * z / 3.0) * torch.exp(-z)


KERNELS: Dict[str, Callable[..., Tensor]] = {
    "rbf": rbf,
    "laplacian": laplacian,
    "linear": linear,
    "polynomial": polynomial,
    "sigmoid": sigmoid,
    "matern32": matern32,
    "matern52": matern52,
}


def get_kernel(name: str, **params: Any) -> Callable[[Tensor, Tensor], Tensor]:
    """Return ``k(X, Y) -> K`` with hyperparameters bound."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; available: {sorted(KERNELS)}")
    return functools.partial(KERNELS[name], **params)

