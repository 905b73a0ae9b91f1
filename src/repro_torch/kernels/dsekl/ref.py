"""Plain-torch oracle for the serving op (port of
``repro/kernels/dsekl/ref.py::ref_kernel_matvec``).

The vecmat, dual-pass and train-pass oracles come with the training slice.
"""
from __future__ import annotations

from typing import Callable

import torch

Tensor = torch.Tensor


def ref_kernel_matvec(kernel: Callable[[Tensor, Tensor], Tensor],
                      x: Tensor, z: Tensor, a: Tensor) -> Tensor:
    """f = K(x, z) @ a   — x (i, d), z (j, d), a (j,) -> (i,)."""
    return kernel(x, z) @ a
