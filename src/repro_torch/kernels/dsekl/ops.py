"""Public kernel ops of the port (counterpart of
``repro/kernels/dsekl/ops.py``).

``impl`` selects the backend as ``repro_torch.kernels.resolve_backend``
does: ``"ref"`` is the plain-torch oracle (``ref.py``), ``"cuda"`` the
hand-written Hopper kernels (``block.*_cuda``).  A CUDA tensor under
``auto`` or ``cuda`` always launches the kernel, and an unknown kernel
name raises.

Ops:
  * ``kernel_matvec``       — f = K(x, z) @ a
  * ``kernel_vecmat``       — g = K(x, z)^T @ v
  * ``kernel_dual_pass``    — both products from ONE evaluation of K; with
    ``loss=...`` the loss gradient v = dloss/df(f, y) is fused between the
    two products (the doubly stochastic training step in one op).  The CUDA
    path takes the route of ``block.select_train_route``; on the fp32 route
    above ``block.STASH_BUDGET`` it falls back to matvec then vecmat.
  * ``kernel_train_pass_indexed`` — the training step on the rows that
    ``idx_i`` / ``idx_j`` pick from (x, y, alpha), + lam * alpha_J: on the
    sm90 route the kernel reads them by index, with no gather before it.
  * ``kernel_matvec_tiled`` — the same, consuming z in ``z_block``-row tiles
    on the ref path (peak intermediate O(|x| * z_block)); the CUDA kernel
    streams z itself and ignores ``z_block``.  The engine's serve function
    and ``core/dsekl.decision_function`` run on it.
  * ``kernel_block``        — K materialized (ref only, as in JAX).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import kernels_fn
from repro_torch.core import losses as losses_lib
from repro_torch.kernels import full_fp32_matmul, resolve_backend
from repro_torch.kernels.dsekl import block as _blk
from repro_torch.kernels.dsekl import ref as _ref

Tensor = torch.Tensor


def resolve_impl(impl: str, kernel_name: str, device: torch.device) -> str:
    """Resolve ``impl`` to the backend that will run for tensors on
    ``device``: ``"ref"`` or ``"cuda"``."""
    impl = resolve_backend(impl, device)
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


def kernel_matvec(x: Tensor, z: Tensor, a: Tensor, *,
                  kernel_name: str = "rbf",
                  kernel_params: tuple = (("gamma", 1.0),),
                  impl: str = "auto") -> Tensor:
    """f = K(x, z) @ a; on the CUDA path K is never materialized."""
    params: Dict[str, Any] = dict(kernel_params)
    if resolve_impl(impl, kernel_name, x.device) == "ref":
        with full_fp32_matmul():
            return _ref.ref_kernel_matvec(
                kernels_fn.get_kernel(kernel_name, **params), x, z, a)
    return _blk.kernel_matvec_cuda(_f32(x), _f32(z), _f32(a),
                                   kernel_name=kernel_name, params=params)


def kernel_vecmat(x: Tensor, z: Tensor, v: Tensor, *,
                  kernel_name: str = "rbf",
                  kernel_params: tuple = (("gamma", 1.0),),
                  impl: str = "auto") -> Tensor:
    """g = K(x, z)^T @ v; on the CUDA path K is never materialized."""
    params: Dict[str, Any] = dict(kernel_params)
    if resolve_impl(impl, kernel_name, x.device) == "ref":
        with full_fp32_matmul():
            return _ref.ref_kernel_vecmat(
                kernels_fn.get_kernel(kernel_name, **params), x, z, v)
    return _blk.kernel_vecmat_cuda(_f32(x), _f32(z), _f32(v),
                                   kernel_name=kernel_name, params=params)


def kernel_dual_pass(x: Tensor, z: Tensor, a: Tensor, vy: Tensor, *,
                     kernel_name: str = "rbf",
                     kernel_params: tuple = (("gamma", 1.0),),
                     loss: Optional[str] = None, f_scale: float = 1.0,
                     impl: str = "auto") -> Tuple[Tensor, Tensor]:
    """Both products of K(x, z) from ONE kernel-block evaluation.

    * ``loss=None``: ``vy`` is the dual-gradient vector v (i,).  Returns
      ``(f, g) = (f_scale * K @ a, K^T @ vy)``.
    * ``loss="hinge"`` (etc.): ``vy`` is the label vector y (i,).  Returns
      ``(f, g)`` with ``f = f_scale * K @ a`` and ``g = K^T @ v`` for
      ``v = loss.grad_f(f, y)``: paper Alg. 1 lines 4-5 in one op.

    ``f_scale`` (the unbiased N/|J| scaling) is applied after the product
    and, with a loss, *before* the loss gradient is taken.  On the CUDA
    path a block on the fp32 route (``block.select_train_route``) whose K
    stash is over ``block.STASH_BUDGET`` falls back to matvec then vecmat,
    K evaluated twice (the JAX op's fallback when ``train_pass_blocks``
    returns None)."""
    params: Dict[str, Any] = dict(kernel_params)
    loss_grad = losses_lib.get_loss(loss).grad_f if loss is not None else None
    if resolve_impl(impl, kernel_name, x.device) == "ref":
        k = kernels_fn.get_kernel(kernel_name, **params)
        with full_fp32_matmul():
            if loss_grad is None:
                f, g = _ref.ref_kernel_dual_pass(k, x, z, a, vy)
                return f_scale * f, g
            return _ref.ref_kernel_train_pass(k, x, z, a, vy, loss_grad,
                                              f_scale=f_scale)
    x, z, a, vy = _f32(x), _f32(z), _f32(a), _f32(vy)
    if (_blk.select_train_route(x.shape[0], z.shape[0], x.shape[1],
                                kernel_name) == "fp32"
            and not _blk.fits_stash(x.shape[0], z.shape[0])):
        f = f_scale * _blk.kernel_matvec_cuda(x, z, a, kernel_name=kernel_name,
                                              params=params)
        v = vy if loss_grad is None else loss_grad(f, vy)
        g = _blk.kernel_vecmat_cuda(x, z, v.contiguous(),
                                    kernel_name=kernel_name, params=params)
        return f, g
    if loss is None:
        return _blk.dual_pass_cuda(x, z, a, vy, kernel_name=kernel_name,
                                   params=params, f_scale=f_scale)
    return _blk.train_pass_cuda(x, z, a, vy, loss=loss,
                                kernel_name=kernel_name, params=params,
                                f_scale=f_scale)


def kernel_train_pass_indexed(x: Tensor, y: Tensor, alpha: Tensor,
                              idx_i: Tensor, idx_j: Tensor, *,
                              kernel_name: str = "rbf",
                              kernel_params: tuple = (("gamma", 1.0),),
                              loss: str = "hinge", f_scale: float = 1.0,
                              lam: float = 0.0, impl: str = "auto"
                              ) -> Tuple[Tensor, Tensor]:
    """The fused training step on the rows that the indices pick: with
    xi = x[idx_i], yi = y[idx_i], xj = x[idx_j], aj = alpha[idx_j],

        f = f_scale * K(xi, xj) @ aj;  v = loss.grad_f(f, yi);
        g = K^T @ v + lam * aj

    (Alg. 1 lines 4-5 with the ridge term), position by position: a
    duplicate index of J gets its own g entry.  x (N, D), y (N,), alpha
    (N,), idx_i (I,), idx_j (J,) integer indices in [0, N).

    Ref path: the gathers, then ``ref_kernel_train_pass``.  CUDA path: on
    the sm90 route (``block.select_train_route``: J up to
    ``block.SM90_TRAIN_MAX_J`` = 4,096, so Algorithm 1's step and
    Algorithm 2's J union at the paper's protocol) one launch that reads
    the rows by index and adds lam (``block.train_pass_indexed_cuda``);
    on the fp32 route (wider J) the same wrapper gathers first, and above
    ``block.STASH_BUDGET`` the gathered rows take ``kernel_dual_pass``'s
    matvec-then-vecmat fallback."""
    params: Dict[str, Any] = dict(kernel_params)
    loss_grad = losses_lib.get_loss(loss).grad_f
    if resolve_impl(impl, kernel_name, x.device) == "ref":
        aj = alpha[idx_j]
        k = kernels_fn.get_kernel(kernel_name, **params)
        with full_fp32_matmul():
            f, g = _ref.ref_kernel_train_pass(k, x[idx_i], x[idx_j], aj,
                                              y[idx_i], loss_grad,
                                              f_scale=f_scale)
        return f, g + lam * aj
    x, y, alpha = _f32(x), _f32(y), _f32(alpha)
    idx_i, idx_j = idx_i.to(torch.int64), idx_j.to(torch.int64)
    n_i, n_j = idx_i.shape[0], idx_j.shape[0]
    if (_blk.select_train_route(n_i, n_j, x.shape[1], kernel_name) == "fp32"
            and not _blk.fits_stash(n_i, n_j)):
        aj = alpha[idx_j]
        f, g = kernel_dual_pass(x[idx_i], x[idx_j], aj, y[idx_i],
                                kernel_name=kernel_name,
                                kernel_params=kernel_params, loss=loss,
                                f_scale=f_scale, impl="cuda")
        return f, g + lam * aj
    return _blk.train_pass_indexed_cuda(
        x, y, alpha, idx_i.contiguous(), idx_j.contiguous(), loss=loss,
        kernel_name=kernel_name, params=params, f_scale=f_scale, lam=lam)


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
    k = kernels_fn.get_kernel(kernel_name, **params)
    z_tiles = tile_rows(z, z_block)
    a_tiles = tile_rows(a.to(torch.float32), z_block)
    f = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    with full_fp32_matmul():
        for zt, at in zip(z_tiles, a_tiles):
            f = f + _ref.ref_kernel_matvec(k, x, zt, at)
    return f


def kernel_block(x: Tensor, z: Tensor, *, kernel_name: str = "rbf",
                 kernel_params: tuple = (("gamma", 1.0),)) -> Tensor:
    """K(x, z) materialized (the engine's cache-miss path), in full
    float32."""
    with full_fp32_matmul():
        return kernels_fn.get_kernel(kernel_name, **dict(kernel_params))(x, z)
