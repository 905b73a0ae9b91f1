"""Public kernel ops of the port (counterpart of
``repro/kernels/dsekl/ops.py``; the serving subset).

``impl`` selects the backend:
  * ``"ref"``  — the plain-torch oracle (``ref.py``), on whatever device the
                 tensors are on;
  * ``"cuda"`` — the hand-written Hopper kernel (``block.kernel_matvec_cuda``);
                 CUDA tensors only, it raises for CPU tensors;
  * ``"auto"`` — ``cuda`` for CUDA tensors, ``ref`` for CPU tensors.

``"auto"`` honours the ``REPRO_TORCH_IMPL`` env override (``REPRO_IMPL``
belongs to the JAX package's CI legs).  There is no silent fallback: a CUDA
tensor under ``auto`` or ``cuda`` always launches the kernel, and an
unknown kernel name raises.

Ops:
  * ``kernel_matvec``       — f = K(x, z) @ a
  * ``kernel_matvec_tiled`` — the same, consuming z in ``z_block``-row tiles
    on the ref path (peak intermediate O(|x| * z_block)); the CUDA kernel
    streams z itself and ignores ``z_block``.  The engine's serve function
    and ``core/dsekl.decision_function`` run on it.
  * ``kernel_block``        — K materialized (ref only, as in JAX).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch

from repro_torch.core import kernels_fn
from repro_torch.kernels.dsekl import block as _blk
from repro_torch.kernels.dsekl import ref as _ref

Tensor = torch.Tensor

_IMPLS = ("auto", "ref", "cuda")
ENV_IMPL = "REPRO_TORCH_IMPL"


def resolve_impl(impl: str, kernel_name: str, device: torch.device) -> str:
    """Resolve ``impl`` to the backend that will run for tensors on
    ``device``: ``"ref"`` or ``"cuda"``."""
    if impl not in _IMPLS:
        raise ValueError(f"impl={impl!r} is not one of {_IMPLS}")
    if impl == "auto":
        impl = os.environ.get(ENV_IMPL, "auto") or "auto"
        if impl not in _IMPLS:
            raise ValueError(f"{ENV_IMPL}={impl!r} is not one of {_IMPLS}")
    if impl == "auto":
        impl = "cuda" if torch.device(device).type == "cuda" else "ref"
    if impl == "cuda" and kernel_name not in _blk.KINDS:
        raise ValueError(f"no CUDA kernel for {kernel_name!r}; "
                         f"available: {sorted(_blk.KINDS)}")
    return impl


# ---------------------------------------------------------------------------
# Row-tiling helpers (one zero-row padding convention everywhere).
# ---------------------------------------------------------------------------

def pad_rows_to_block(x: Tensor, block: int) -> Tensor:
    """Zero-pad axis 0 up to the next multiple of ``block``."""
    return _blk._pad_rows(x, block)


def tile_rows(x: Tensor, block: int) -> Tensor:
    """(n, ...) -> (n_tiles, block, ...) with zero-padded tail rows."""
    xp = pad_rows_to_block(x, block)
    return xp.reshape((xp.shape[0] // block, block) + tuple(xp.shape[1:]))


def _f32(t: Tensor) -> Tensor:
    return t.to(torch.float32).contiguous()


def _ref_kernel(kernel_name: str, params: Dict[str, Any], x: Tensor):
    """The registry kernel for a ref evaluation (full float32 products on
    the card)."""
    if x.is_cuda:
        _blk.full_fp32_matmul()
    return kernels_fn.get_kernel(kernel_name, **params)


def kernel_matvec(x: Tensor, z: Tensor, a: Tensor, *,
                  kernel_name: str = "rbf",
                  kernel_params: tuple = (("gamma", 1.0),),
                  impl: str = "auto") -> Tensor:
    """f = K(x, z) @ a; on the CUDA path K is never materialized."""
    params: Dict[str, Any] = dict(kernel_params)
    if resolve_impl(impl, kernel_name, x.device) == "ref":
        return _ref.ref_kernel_matvec(_ref_kernel(kernel_name, params, x),
                                      x, z, a)
    return _blk.kernel_matvec_cuda(_f32(x), _f32(z), _f32(a),
                                   kernel_name=kernel_name, params=params)


def kernel_matvec_tiled(x: Tensor, z: Tensor, a: Tensor, *,
                        kernel_name: str = "rbf",
                        kernel_params: tuple = (("gamma", 1.0),),
                        z_block: int = 4096, impl: str = "auto") -> Tensor:
    """f = K(x, z) @ a consuming z in ``z_block``-row tiles.

    Ref path: a loop over the zero-padded tiles, accumulated in tile order
    (the JAX ``lax.scan``); padded rows carry zero ``a`` and add exactly
    nothing.  CUDA path: one kernel launch over the whole z."""
    params: Dict[str, Any] = dict(kernel_params)
    if resolve_impl(impl, kernel_name, x.device) == "cuda":
        return _blk.kernel_matvec_cuda(_f32(x), _f32(z), _f32(a),
                                       kernel_name=kernel_name, params=params)
    k = _ref_kernel(kernel_name, params, x)
    z_tiles = tile_rows(z, z_block)
    a_tiles = tile_rows(a.to(torch.float32), z_block)
    f = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    for zt, at in zip(z_tiles, a_tiles):
        f = f + _ref.ref_kernel_matvec(k, x, zt, at)
    return f


def kernel_block(x: Tensor, z: Tensor, *, kernel_name: str = "rbf",
                 kernel_params: tuple = (("gamma", 1.0),)) -> Tensor:
    """K(x, z) materialized (the engine's cache-miss path)."""
    return _ref_kernel(kernel_name, dict(kernel_params), x)(x, z)
