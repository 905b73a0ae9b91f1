"""Baselines the paper compares against (§4, Fig. 2, Table 1; port of
``repro/core/baselines.py``).

* ``rks``      — random kitchen sinks [Rahimi & Recht 2008]: explicit random
                 Fourier features for the RBF kernel + linear SGD on the
                 primal weights, the optimizer loop of DSEKL's Alg. 1.
* ``emp_fix``  — fixed random subsample: the empirical kernel map expanded
                 on ONE fixed random landmark set (Nystrom-style baseline);
                 only the gradient batch I is stochastic.  Its step is one
                 ``kops.kernel_matvec`` and one ``kops.kernel_vecmat``: on
                 the card the hand-written matvec kernel and the same
                 kernel with its operands swapped.
* ``batch``    — full-batch kernel SVM on the complete N x N kernel matrix
                 (full subgradient + AdaGrad).

The JAX package draws I, the features and the landmarks from a key; here
they come from a ``torch.Generator``, and every draw also takes explicit
values (``idx_i`` a step, ``indices`` of the landmarks; RKS's features
through ``convert.rks_from_jax``), which is how the tests feed both
packages the same numbers.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import kernels_fn, losses as losses_lib
from repro_torch.core.dsekl import DSEKLConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import full_fp32_matmul
from repro_torch.kernels.dsekl import ops as kops

Tensor = torch.Tensor


def _lr(lr0: float, t: Tensor) -> Tensor:
    """lr0 / max(t, 1), the 1/t schedule of both SGD baselines."""
    return lr0 / torch.clamp_min(t.to(torch.float32), 1.0)


# ---------------------------------------------------------------------------
# Random kitchen sinks.
# ---------------------------------------------------------------------------

class RKSModel(NamedTuple):
    w_feat: Tensor   # (D, J) random projection ~ N(0, 2*gamma)
    b_feat: Tensor   # (J,)   random phases  ~ U[0, 2pi]
    weights: Tensor  # (J,)   learned linear weights
    step: Tensor


def rks_features(x: Tensor, w_feat: Tensor, b_feat: Tensor) -> Tensor:
    """z(x) = sqrt(2/J) cos(x W + b): Fourier features of the RBF kernel."""
    scale = torch.sqrt(torch.tensor(2.0 / w_feat.shape[1],
                                    dtype=torch.float32))
    with full_fp32_matmul():
        return scale.to(x.device) * torch.cos(x @ w_feat + b_feat)


def rks_init(gen: torch.Generator, d: int, n_features: int, gamma: float,
             device: DeviceLike = None) -> RKSModel:
    """Features drawn from ``gen`` (on its device), the model on
    ``device``."""
    dev = resolve_device(device)
    w = torch.randn((d, n_features), generator=gen, device=gen.device)
    b = torch.rand((n_features,), generator=gen, device=gen.device)
    w = w * math.sqrt(2.0 * gamma)
    b = b * (2.0 * math.pi)
    return RKSModel(w.to(dev), b.to(dev),
                    torch.zeros((n_features,), device=dev),
                    torch.zeros((), dtype=torch.int32, device=dev))


def rks_step(cfg: DSEKLConfig, model: RKSModel, x: Tensor, y: Tensor,
             idx_i: Tensor) -> RKSModel:
    """One SGD step on the gradient batch ``idx_i`` (Alg. 1's I; draw it
    with ``sampler.sample_uniform``)."""
    loss = losses_lib.get_loss(cfg.loss)
    zi = rks_features(x[idx_i], model.w_feat, model.b_feat)
    with full_fp32_matmul():
        f = zi @ model.weights
        v = loss.grad_f(f, y[idx_i])
        g = zi.T @ v + cfg.lam * model.weights
    t = model.step + 1
    return model._replace(weights=model.weights - _lr(cfg.lr0, t) * g,
                          step=t)


def rks_decision(model: RKSModel, x: Tensor) -> Tensor:
    z = rks_features(x, model.w_feat, model.b_feat)
    with full_fp32_matmul():
        return z @ model.weights


# ---------------------------------------------------------------------------
# Fixed random subsample of the empirical kernel map (Emp_Fix).
# ---------------------------------------------------------------------------

class EmpFixModel(NamedTuple):
    landmarks: Tensor  # (J, D) fixed expansion points
    alpha: Tensor      # (J,)
    step: Tensor


def emp_fix_init(gen: Optional[torch.Generator], x: Tensor,
                 n_landmarks: int, *,
                 indices: Optional[Tensor] = None) -> EmpFixModel:
    """``n_landmarks`` rows of ``x`` drawn without replacement from
    ``gen``, or the rows ``indices`` when given."""
    if indices is None:
        indices = torch.randperm(x.shape[0], generator=gen,
                                 device=gen.device)[:n_landmarks]
    indices = torch.as_tensor(indices).to(device=x.device,
                                          dtype=torch.int64)
    return EmpFixModel(x[indices],
                       torch.zeros((indices.shape[0],), device=x.device),
                       torch.zeros((), dtype=torch.int32, device=x.device))


def emp_fix_step(cfg: DSEKLConfig, model: EmpFixModel, x: Tensor, y: Tensor,
                 idx_i: Tensor) -> EmpFixModel:
    """One SGD step on the gradient batch ``idx_i`` against the fixed
    landmarks: f by the matvec, g by the vecmat."""
    loss = losses_lib.get_loss(cfg.loss)
    xi, yi = x[idx_i], y[idx_i]
    f = kops.kernel_matvec(xi, model.landmarks, model.alpha,
                           kernel_name=cfg.kernel,
                           kernel_params=cfg.kernel_params, impl=cfg.impl)
    v = loss.grad_f(f, yi)
    g = kops.kernel_vecmat(xi, model.landmarks, v, kernel_name=cfg.kernel,
                           kernel_params=cfg.kernel_params, impl=cfg.impl)
    g = g + cfg.lam * model.alpha
    t = model.step + 1
    return model._replace(alpha=model.alpha - _lr(cfg.lr0, t) * g, step=t)


def emp_fix_decision(cfg: DSEKLConfig, model: EmpFixModel,
                     x: Tensor) -> Tensor:
    return kops.kernel_matvec(x, model.landmarks, model.alpha,
                              kernel_name=cfg.kernel,
                              kernel_params=cfg.kernel_params, impl=cfg.impl)


# ---------------------------------------------------------------------------
# Batch kernel SVM (full kernel matrix).
# ---------------------------------------------------------------------------

def batch_svm_fit(cfg: DSEKLConfig, x: Tensor, y: Tensor, *,
                  n_iters: int = 500, lr0: float = 1.0) -> Tensor:
    """Full-batch subgradient descent with AdaGrad on the complete K, on
    ``x``'s device."""
    loss = losses_lib.get_loss(cfg.loss)
    kernel = kernels_fn.get_kernel(cfg.kernel, **dict(cfg.kernel_params))
    n = x.shape[0]
    alpha = torch.zeros((n,), device=x.device)
    accum = torch.ones((n,), device=x.device)
    with full_fp32_matmul():
        kmat = kernel(x, x)
        for _ in range(n_iters):
            f = kmat @ alpha
            v = loss.grad_f(f, y)
            g = kmat.T @ v + cfg.lam * alpha
            accum = accum + g * g
            alpha = alpha - lr0 * g * torch.rsqrt(accum)
    return alpha


def batch_svm_decision(cfg: DSEKLConfig, alpha: Tensor, x_train: Tensor,
                       x: Tensor) -> Tensor:
    kernel = kernels_fn.get_kernel(cfg.kernel, **dict(cfg.kernel_params))
    with full_fp32_matmul():
        return kernel(x, x_train) @ alpha
