"""RBF-bound delegations (port of ``repro/kernels/dsekl/rbf_block.py``).

The JAX module keeps the historical RBF-only API of the first Pallas
kernels as thin delegations to the generalized ones: ``rbf_matvec_pallas``
and ``rbf_vecmat_pallas`` call ``kernel_matvec_pallas`` and
``kernel_vecmat_pallas`` with ``kernel_name="rbf"``.  Here they delegate to
``ops.kernel_matvec`` / ``ops.kernel_vecmat`` (the hand-written Hopper
kernels on the card, the plain-torch ref on the CPU).

Left out: ``choose_blocks``, ``pass_hbm_bytes`` and the ``BLOCK_I`` /
``BLOCK_J`` / ``VMEM_BUDGET`` constants it re-exports.  They model the
TPU's VMEM budget and its HBM traffic per Pallas block shape; the CUDA
kernels pick their own tiles, and nothing in the port reads those models.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dsekl import ops

Tensor = torch.Tensor


def rbf_matvec(x: Tensor, z: Tensor, a: Tensor, *, gamma: float = 1.0,
               impl: str = "auto") -> Tensor:
    """f = exp(-gamma ||x - z||^2) @ a.  x (I, D), z (J, D), a (J,) -> (I,)."""
    return ops.kernel_matvec(x, z, a, kernel_name="rbf",
                             kernel_params=(("gamma", gamma),), impl=impl)


def rbf_vecmat(x: Tensor, z: Tensor, v: Tensor, *, gamma: float = 1.0,
               impl: str = "auto") -> Tensor:
    """g = exp(-gamma ||x - z||^2)^T @ v.  x (I, D), z (J, D), v (I,) -> (J,)."""
    return ops.kernel_vecmat(x, z, v, kernel_name="rbf",
                             kernel_params=(("gamma", gamma),), impl=impl)
