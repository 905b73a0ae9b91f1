"""Plain-torch oracles for the kernel ops (port of
``repro/kernels/dsekl/ref.py``).  They are the semantic definition the
plain versions and the CUDA kernels in ``block.py`` are held against.
"""
from __future__ import annotations

from typing import Callable

import torch

Tensor = torch.Tensor


def ref_kernel_matvec(kernel: Callable[[Tensor, Tensor], Tensor],
                      x: Tensor, z: Tensor, a: Tensor) -> Tensor:
    """f = K(x, z) @ a   — x (i, d), z (j, d), a (j,) -> (i,)."""
    return kernel(x, z) @ a


def ref_kernel_vecmat(kernel: Callable[[Tensor, Tensor], Tensor],
                      x: Tensor, z: Tensor, v: Tensor) -> Tensor:
    """g = K(x, z)^T @ v — x (i, d), z (j, d), v (i,) -> (j,)."""
    return kernel(x, z).T @ v


def ref_kernel_dual_pass(kernel: Callable[[Tensor, Tensor], Tensor],
                         x: Tensor, z: Tensor, a: Tensor, v: Tensor):
    """(f, g) = (K @ a, K^T @ v) with K evaluated ONCE."""
    km = kernel(x, z)
    return km @ a, km.T @ v


def ref_kernel_train_pass(kernel: Callable[[Tensor, Tensor], Tensor],
                          x: Tensor, z: Tensor, a: Tensor, y: Tensor,
                          loss_grad: Callable[[Tensor, Tensor], Tensor],
                          f_scale: float = 1.0):
    """The fused training-step math, K evaluated ONCE:

        f = f_scale * K @ a;  v = loss_grad(f, y);  g = K^T @ v."""
    km = kernel(x, z)
    f = f_scale * (km @ a)
    return f, km.T @ loss_grad(f, y)
