"""DSEKL model configuration, state, Algorithm 1's step and prediction
(port of ``repro/core/dsekl.py``; Algorithm 2, the mesh hooks and
EigenPro are not ported yet).

``DSEKLConfig`` carries every field of the JAX config, so a JAX config maps
onto it 1:1 (``repro_torch.convert.config_from_jax``); fields of paths not
ported yet (``n_workers``, ``compress_bits``, ``precondition_*``,
``bcd_*``) are kept for that mapping.

Algorithm 1 (serial): every step takes two index sets, I (gradient points)
and J (kernel-map expansion points), computes the dual gradient on the
sampled K_{I,J} block (``grad_block``: the fused train pass, the two-pass
matvec + vecmat, or the streamed ref pass) and scatters it into alpha_J
(``apply_update``).  The state updates are out of place, as in JAX, so a
caller holding the previous alpha keeps it.

Prediction is the empirical kernel map over any expansion set:
``f(x) = K(x, X_train) @ alpha``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import losses as losses_lib
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
# Block computation (Algorithm 1's step body).
# ---------------------------------------------------------------------------

def _block_f(cfg: DSEKLConfig, xi: Tensor, xj: Tensor, aj: Tensor,
             n: int) -> Tensor:
    """Partial decision values f_I from one expansion block (matvec)."""
    f = kops.kernel_matvec(xi, xj, aj, kernel_name=cfg.kernel,
                           kernel_params=cfg.kernel_params, impl=cfg.impl)
    if cfg.unbiased_scaling:
        f = f * (n / xj.shape[0])
    return f


def _block_grad(cfg: DSEKLConfig, xi: Tensor, xj: Tensor, aj: Tensor,
                v: Tensor) -> Tensor:
    """g_J = K_{I,J}^T v + lam * alpha_J for one block (vecmat)."""
    g = kops.kernel_vecmat(xi, xj, v, kernel_name=cfg.kernel,
                           kernel_params=cfg.kernel_params, impl=cfg.impl)
    return g + cfg.lam * aj


def _fused_f_and_grad(cfg: DSEKLConfig, xi: Tensor, yi: Tensor, xj: Tensor,
                      aj: Tensor, n: int) -> Tuple[Tensor, Tensor]:
    """f_I and g_J = K^T dloss/df + lam*alpha_J with K_{I,J} evaluated ONCE
    (the fused train pass; the two-pass path evaluates K per product)."""
    f_scale = (n / xj.shape[0]) if cfg.unbiased_scaling else 1.0
    f, g = kops.kernel_dual_pass(
        xi, xj, aj, yi, kernel_name=cfg.kernel,
        kernel_params=cfg.kernel_params, loss=cfg.loss, f_scale=f_scale,
        impl=cfg.impl)
    return f, g + cfg.lam * aj


def streaming_train_pass(cfg: DSEKLConfig, xi: Tensor, yi: Tensor,
                         xj: Tensor, aj: Tensor, n: int, *,
                         row_block: int) -> Tuple[Tensor, Tensor]:
    """The fused step body consuming K_{I,J} in (row_block, |J|) tiles of
    the gradient batch, each evaluated ONCE:

        f_b = f_scale * K_b @ a_J;  v_b = dloss/df(f_b, y_b);  g += K_b^T v_b

    so the peak kernel-block intermediate is O(row_block * |J|).  Zero-
    padded tail rows get their v masked to zero.  Returns ``(f (|I|,),
    g (|J|,))``, g without the lam*alpha_J term.  (The JAX function's
    ``f_reduce`` hook serves the mesh step, which is not ported yet.)"""
    loss = losses_lib.get_loss(cfg.loss)
    n_i = xi.shape[0]
    f_scale = (n / xj.shape[0]) if cfg.unbiased_scaling else 1.0
    xi_t = kops.tile_rows(xi, row_block)                    # (nb, rb, D)
    yi_t = kops.tile_rows(yi, row_block)                    # (nb, rb)
    valid = kops.tile_rows(
        torch.ones((n_i,), dtype=torch.float32, device=xi.device), row_block)
    g = torch.zeros((xj.shape[0],), dtype=torch.float32, device=xj.device)
    fs = []
    for xb, yb, mb in zip(xi_t, yi_t, valid):
        kb = kops.kernel_block(xb, xj, kernel_name=cfg.kernel,
                               kernel_params=cfg.kernel_params)   # ONCE
        fb = f_scale * (kb @ aj)
        vb = loss.grad_f(fb, yb) * mb
        g = g + kb.T @ vb
        fs.append(fb)
    return torch.cat(fs)[:n_i], g


def _lr(cfg: DSEKLConfig, state: "DSEKLState") -> Tensor:
    """The step's learning rate as a 0-d float32 tensor on the state's
    device (no host synchronisation); read after ``step`` is incremented."""
    if cfg.schedule == "inv_t":
        return cfg.lr0 / torch.clamp_min(state.step.to(torch.float32), 1.0)
    if cfg.schedule == "inv_epoch":
        return cfg.lr0 / torch.clamp_min(state.epoch.to(torch.float32), 1.0)
    if cfg.schedule in ("const", "adagrad"):
        return torch.full((), cfg.lr0, dtype=torch.float32,
                          device=state.alpha.device)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def _grad_block_with_f(cfg: DSEKLConfig, xi: Tensor, yi: Tensor, xj: Tensor,
                       aj: Tensor, n: int) -> Tuple[Tensor, Tensor]:
    """``grad_block``'s body, also returning the decision values f_I."""
    stream = (cfg.stream_row_block > 0
              and kops.resolve_impl(cfg.impl, cfg.kernel, xi.device) == "ref")
    if stream:
        # The CUDA train pass streams K through its stash already, so the
        # streamed form applies to the ref path only.
        f, g = streaming_train_pass(cfg, xi, yi, xj, aj, n,
                                    row_block=cfg.stream_row_block)
        return f, g + cfg.lam * aj
    if cfg.fuse_dual_pass:
        return _fused_f_and_grad(cfg, xi, yi, xj, aj, n)
    f = _block_f(cfg, xi, xj, aj, n)
    v = losses_lib.get_loss(cfg.loss).grad_f(f, yi)
    return f, _block_grad(cfg, xi, xj, aj, v)


def grad_block(cfg: DSEKLConfig, xi: Tensor, yi: Tensor, xj: Tensor,
               aj: Tensor, n: int = 0) -> Tensor:
    """Alg.-1 dual gradient g_J (incl. lam*alpha_J) for one gathered block:
    xi (n_grad, D), yi (n_grad,), xj (n_expand, D), aj (n_expand,).  ``n``
    is read only under ``cfg.unbiased_scaling`` (the N/|J| scale)."""
    _, g = _grad_block_with_f(cfg, xi, yi, xj, aj, n)
    return g


def apply_update(cfg: DSEKLConfig, state: DSEKLState, idx_j: Tensor,
                 g: Tensor) -> DSEKLState:
    """Scatter one Alg.-1 block gradient into the O(N) state, out of place.

    J is sampled with replacement: ``index_add`` adds duplicate indices
    together, as JAX's ``.at[idx].add`` does (``alpha[idx] += g`` would
    keep one of them).  Under adagrad the accumulator takes every g_j^2
    first, then each duplicate reads back the accumulated value."""
    state = state._replace(step=state.step + 1)
    if cfg.schedule == "adagrad":
        accum = state.accum.index_add(0, idx_j, g * g)
        damp = torch.rsqrt(accum[idx_j])
        alpha = state.alpha.index_add(0, idx_j, -_lr(cfg, state) * damp * g)
        return state._replace(alpha=alpha, accum=accum)
    alpha = state.alpha.index_add(0, idx_j, -_lr(cfg, state) * g)
    return state._replace(alpha=alpha)


def scale_n(cfg: DSEKLConfig, n: int) -> int:
    """The ``n`` a gradient core needs: the dataset size when
    ``unbiased_scaling`` is on, else 0."""
    return n if cfg.unbiased_scaling else 0


def step_serial(cfg: DSEKLConfig, state: DSEKLState, x: Tensor, y: Tensor,
                idx_i: Tensor, idx_j: Tensor) -> DSEKLState:
    """One Alg.-1 iteration on the index sets ``idx_i`` (n_grad,) and
    ``idx_j`` (n_expand,) (``sampler.sample_uniform`` draws them; the JAX
    step draws them from its key).  x (N, D), y (N,) on the state's
    device: compute the block gradient, scatter.

    On the CUDA backend the fused step hands the indices to
    ``ops.kernel_train_pass_indexed``, whose kernel reads the rows of x, y
    and alpha itself (no gather before it) and adds lam * alpha_J.  Every
    other path gathers the blocks first and runs ``grad_block``."""
    n = x.shape[0]
    if (cfg.fuse_dual_pass
            and kops.resolve_impl(cfg.impl, cfg.kernel, x.device) == "cuda"):
        _, g = kops.kernel_train_pass_indexed(
            x, y, state.alpha, idx_i, idx_j, kernel_name=cfg.kernel,
            kernel_params=cfg.kernel_params, loss=cfg.loss,
            f_scale=(n / idx_j.shape[0]) if cfg.unbiased_scaling else 1.0,
            lam=cfg.lam, impl="cuda")
        return apply_update(cfg, state, idx_j, g)
    xi, yi = x[idx_i], y[idx_i]
    xj, aj = x[idx_j], state.alpha[idx_j]
    g = grad_block(cfg, xi, yi, xj, aj, scale_n(cfg, n))
    return apply_update(cfg, state, idx_j, g)


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
