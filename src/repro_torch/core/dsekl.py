"""DSEKL model configuration, state and prediction (port of
``repro/core/dsekl.py``; the serving subset).

``DSEKLConfig`` carries every field of the JAX config, so a JAX config maps
onto it 1:1 (``repro_torch.convert.config_from_jax``); fields that only the
training paths read are kept for that mapping and used by the training
slice.  Prediction is the empirical kernel map over any expansion set:
``f(x) = K(x, X_train) @ alpha``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dsekl import ops as kops

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DSEKLConfig:
    """Hyperparameters of the doubly stochastic learner (hashable).  Field
    meanings as in ``repro.core.dsekl.DSEKLConfig``; ``impl`` takes the
    port's backends ``"auto" | "ref" | "cuda"`` (kernels/dsekl/ops.py)."""
    n_grad: int = 128
    n_expand: int = 128
    kernel: str = "rbf"
    kernel_params: Tuple[Tuple[str, float], ...] = (("gamma", 1.0),)
    loss: str = "hinge"
    lam: float = 1e-3
    lr0: float = 1.0
    schedule: str = "inv_t"
    n_workers: int = 1
    unbiased_scaling: bool = False
    impl: str = "auto"
    fuse_dual_pass: bool = True
    compress_bits: int = 0
    stream_row_block: int = 0
    execution: str = "auto"
    precondition_k: int = 0
    precondition_m: int = 0
    precondition_damping: float = 0.95
    precondition_auto_lr: bool = True
    bcd_block: int = 0
    bcd_row_block: int = 0
    bcd_shards: int = 0
    bcd_jitter: float = 1e-6

    def replace(self, **kw) -> "DSEKLConfig":
        return dataclasses.replace(self, **kw)


class DSEKLState(NamedTuple):
    alpha: Tensor          # (N,) dual coefficients — the entire model
    accum: Tensor          # (N,) AdaGrad accumulator G_jj (init 1)
    step: Tensor           # () int32, t of Alg. 1
    epoch: Tensor          # () int32


def init_state(n: int, dtype=torch.float32,
               device: DeviceLike = None) -> DSEKLState:
    dev = resolve_device(device)
    return DSEKLState(
        alpha=torch.zeros((n,), dtype=dtype, device=dev),
        accum=torch.ones((n,), dtype=dtype, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        epoch=torch.zeros((), dtype=torch.int32, device=dev),
    )


# ---------------------------------------------------------------------------
# Prediction — empirical kernel map over any expansion set.
# ---------------------------------------------------------------------------

def decision_function(cfg: DSEKLConfig, alpha: Tensor, x_train: Tensor,
                      x_test: Tensor, chunk: int = 4096,
                      method: str = "stream") -> Tensor:
    """f(x_test) = K(x_test, x_train) @ alpha, on the tensors' device.

    ``method="stream"``: the tiled matvec over ``chunk``-row tiles of the
    train set (one kernel launch on the CUDA path).  ``method="ref"``: the
    chunk loop of per-chunk matvecs (``decision_function_ref``)."""
    if method == "ref":
        return decision_function_ref(cfg, alpha, x_train, x_test, chunk)
    if method != "stream":
        raise ValueError(f"unknown method {method!r}; use 'stream' or 'ref'")
    return kops.kernel_matvec_tiled(
        x_test, x_train, alpha, kernel_name=cfg.kernel,
        kernel_params=cfg.kernel_params, z_block=chunk, impl=cfg.impl)


def _pad_chunk(xs: Tensor, al: Tensor, chunk: int) -> Tuple[Tensor, Tensor]:
    """Zero-pad a ragged final chunk up to the full chunk shape (exact: the
    padded alpha entries are zero)."""
    pad = chunk - xs.shape[0]
    xs = torch.cat([xs, xs.new_zeros((pad,) + tuple(xs.shape[1:]))])
    al = torch.cat([al, al.new_zeros((pad,))])
    return xs, al


def decision_function_ref(cfg: DSEKLConfig, alpha: Tensor, x_train: Tensor,
                          x_test: Tensor, chunk: int = 4096) -> Tensor:
    """The chunk loop: one matvec per ``chunk`` train rows, a ragged final
    chunk zero-padded to the full chunk shape when there is more than one
    chunk."""
    n = x_train.shape[0]
    out = torch.zeros((x_test.shape[0],), dtype=torch.float32,
                      device=x_test.device)
    for start in range(0, n, chunk):
        xs = x_train[start:start + chunk]
        al = alpha[start:start + chunk]
        if xs.shape[0] < chunk and n > chunk:
            xs, al = _pad_chunk(xs, al, chunk)
        out = out + kops.kernel_matvec(
            x_test, xs, al, kernel_name=cfg.kernel,
            kernel_params=cfg.kernel_params, impl=cfg.impl)
    return out


def predict_labels(f: Tensor) -> Tensor:
    """±1 class decision: ``f >= 0`` maps to +1, else −1 (not ``sign``:
    sign(0) == 0 would count f == 0 as wrong for both classes)."""
    return torch.where(f >= 0.0, 1.0, -1.0).to(torch.float32)


def support_vectors(alpha: Tensor, tol: float = 1e-8) -> Tensor:
    """Indices with non-negligible dual weight, ascending."""
    return torch.nonzero(torch.abs(alpha) > tol, as_tuple=True)[0]


def truncate(alpha: Tensor, x_train: Tensor, tol: float = 1e-8
             ) -> Tuple[Tensor, Tensor]:
    """Compact the model to its support vectors (in index order)."""
    sv = support_vectors(alpha, tol)
    return alpha[sv], x_train[sv]
