"""DSEKL model configuration, state, the steps of Algorithms 1 and 2 with
their EigenPro correction, and prediction (port of ``repro/core/dsekl.py``).

``DSEKLConfig`` carries every field of the JAX config, so a JAX config maps
onto it 1:1 (``repro_torch.convert.config_from_jax``).

Algorithm 1 (serial): every step takes two index sets, I (gradient points)
and J (kernel-map expansion points), computes the dual gradient on the
sampled K_{I,J} block (``grad_block``: the fused train pass, the two-pass
matvec + vecmat, or the streamed ref pass) and scatters it into alpha_J
(``apply_update``).  The state updates are out of place, as in JAX, so a
caller holding the previous alpha keeps it.

Algorithm 2 (parallel): each step takes one gradient batch I and K
disjoint expansion batches J^1..J^K (``sampler.parallel_epoch_plan``); the
workers jointly evaluate f_I = sum_k K_{I,J^k} a_{J^k}, so with
``fuse_dual_pass`` the step is one train pass over the J union
(``grad_block_parallel``), scattered by ``apply_update_parallel``.

EigenPro (DESIGN.md §10): with a ``PrecondBlock`` (``pc``) each step also
forms the correction delta = U ((|J| q) * (U^T K(X_I, X_P)^T v)) from the
step's own v = dloss/df(f_I, y_I), one vecmat over the m subsample rows P,
and scatters alpha_P += lr * delta after the main scatter
(``precond_correction``; ``core/precond.py`` estimates U and q).  With
``pc=None`` every step runs exactly what it ran before.

Prediction is the empirical kernel map over any expansion set:
``f(x) = K(x, X_train) @ alpha``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.core import losses as losses_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import full_fp32_matmul
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
                         row_block: int, f_reduce=None
                         ) -> Tuple[Tensor, Tensor]:
    """The fused step body consuming K_{I,J} in (row_block, |J|) tiles of
    the gradient batch, each evaluated ONCE:

        f_b = f_reduce(f_scale * K_b @ a_J)
        v_b = dloss/df(f_b, y_b);  g += K_b^T v_b

    so the peak kernel-block intermediate is O(row_block * |J|).
    ``f_reduce`` lets the mesh step complete the model axis's reduction
    of the partial decision values per row block, before the loss
    gradient is taken (None: the identity).  Zero-padded tail rows get
    their v masked to zero.  Returns ``(f (|I|,), g (|J|,))``, g without
    the lam*alpha_J term."""
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
        if f_reduce is not None:
            fb = f_reduce(fb)
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


# ---------------------------------------------------------------------------
# EigenPro preconditioning (DESIGN.md §10).
#
# With U (m, k) the generalized eigenvectors of the squared Nystrom
# operator, q (k,) the per-unit damping and P the m subsample rows, a step
# cancels the top-k K^2-eigendirection components of its expected update:
#
#     delta = U ((|J| q) * (U^T (K_{I,P}^T v)))    # (m,)
#     alpha_P += lr * delta                        # after alpha_J -= lr * g
#
# |J| is the step's J-union size (Algorithm 1: n_expand; Algorithm 2:
# n_workers * n_expand): the main update covers |J|/n of the operator per
# step in expectation while the correction fires every step, and the 1/n
# lives in q.  K_{I,P}^T v is one kernel_vecmat over the subsample rows.
# ---------------------------------------------------------------------------

class PrecondBlock(NamedTuple):
    """The EigenPro preconditioner on the device (``precond.py`` stages
    it): rows (m, D) the subsample rows; vectors (m, k) U; damping (k,)
    the per-unit-J q; indices (m,) int64 row ids the correction scatters
    into (distinct)."""
    rows: Tensor
    vectors: Tensor
    damping: Tensor
    indices: Tensor


def precond_correction(cfg: DSEKLConfig, xi: Tensor, v: Tensor,
                       pc: PrecondBlock, j_union: int) -> Tensor:
    """delta = U ((|J| q) * (U^T (K(xi, P)^T v))): the EigenPro correction
    of one step (v = dloss/df at the gradient rows xi; ``j_union`` the
    expansion coordinates the step scatters).  The vecmat is the kernel's
    on the CUDA backend; the two (m, k) products run in full float32."""
    c = kops.kernel_vecmat(xi, pc.rows, v, kernel_name=cfg.kernel,
                           kernel_params=cfg.kernel_params, impl=cfg.impl)
    with full_fp32_matmul():
        return pc.vectors @ ((float(j_union) * pc.damping)
                             * (pc.vectors.T @ c))


def _delta(cfg: DSEKLConfig, xi: Tensor, yi: Tensor, f: Tensor,
           pc: PrecondBlock, j_union: int) -> Tensor:
    """The correction of a step from its gradient rows and its f_I."""
    v = losses_lib.get_loss(cfg.loss).grad_f(f, yi)
    return precond_correction(cfg, xi, v, pc, j_union)


def _apply_correction(cfg: DSEKLConfig, state: DSEKLState, idx_p: Tensor,
                      delta: Tensor) -> DSEKLState:
    """Scatter the correction at the step's scalar rate (adagrad's
    per-coordinate damp applies to the main update only).  Called after
    the main scatter, so ``_lr`` reads the incremented step."""
    alpha = state.alpha.index_add(0, idx_p, _lr(cfg, state) * delta)
    return state._replace(alpha=alpha)


def _maybe_correct(cfg: DSEKLConfig, state: DSEKLState, xi: Tensor,
                   yi: Tensor, f: Tensor, pc: Optional[PrecondBlock],
                   j_union: int, idx_i: Optional[Tensor] = None
                   ) -> DSEKLState:
    """A step's EigenPro correction after its main scatter; the state
    untouched when ``pc`` is None.  With ``idx_i``, xi and yi are the
    whole x and y, gathered at I here (the card's indexed step gathers
    nothing else)."""
    if pc is None:
        return state
    if idx_i is not None:
        xi, yi = xi[idx_i], yi[idx_i]
    return _apply_correction(cfg, state, pc.indices,
                             _delta(cfg, xi, yi, f, pc, j_union))


def grad_block_precond(cfg: DSEKLConfig, xi: Tensor, yi: Tensor, xj: Tensor,
                       aj: Tensor, pc: PrecondBlock, n: int = 0
                       ) -> Tuple[Tensor, Tensor]:
    """``grad_block`` plus the EigenPro correction: (g_J, delta)."""
    f, g = _grad_block_with_f(cfg, xi, yi, xj, aj, n)
    return g, _delta(cfg, xi, yi, f, pc, cfg.n_expand)


def apply_update_precond(cfg: DSEKLConfig, state: DSEKLState, idx_j: Tensor,
                         g: Tensor, idx_p: Tensor, delta: Tensor
                         ) -> DSEKLState:
    """Alg.-1 scatter, then the EigenPro correction's."""
    return _apply_correction(cfg, apply_update(cfg, state, idx_j, g),
                             idx_p, delta)


def _train_pass_indexed(cfg: DSEKLConfig, state: DSEKLState, x: Tensor,
                        y: Tensor, idx_i: Tensor, idx_j: Tensor
                        ) -> Tuple[Tensor, Tensor]:
    """The CUDA backend's fused step: ``ops.kernel_train_pass_indexed`` on
    the indices, whose kernel reads the rows of x, y and alpha itself and
    adds lam * alpha_J.  Returns (f_I, g_J)."""
    n = x.shape[0]
    return kops.kernel_train_pass_indexed(
        x, y, state.alpha, idx_i, idx_j, kernel_name=cfg.kernel,
        kernel_params=cfg.kernel_params, loss=cfg.loss,
        f_scale=(n / idx_j.shape[0]) if cfg.unbiased_scaling else 1.0,
        lam=cfg.lam, impl="cuda")


def _indexed_step(cfg: DSEKLConfig, x: Tensor) -> bool:
    return (cfg.fuse_dual_pass
            and kops.resolve_impl(cfg.impl, cfg.kernel, x.device) == "cuda")


def step_serial(cfg: DSEKLConfig, state: DSEKLState, x: Tensor, y: Tensor,
                idx_i: Tensor, idx_j: Tensor,
                pc: Optional[PrecondBlock] = None) -> DSEKLState:
    """One Alg.-1 iteration on the index sets ``idx_i`` (n_grad,) and
    ``idx_j`` (n_expand,) (``sampler.sample_uniform`` draws them; the JAX
    step draws them from its key).  x (N, D), y (N,) on the state's
    device: compute the block gradient, scatter.

    On the CUDA backend the fused step hands the indices to
    ``ops.kernel_train_pass_indexed``, whose kernel reads the rows of x, y
    and alpha itself (no gather before it) and adds lam * alpha_J.  Every
    other path gathers the blocks first and runs ``grad_block``'s body.  A
    ``PrecondBlock`` adds the EigenPro correction; on the CUDA backend it
    gathers x and y at I (and nothing else) for its vecmat."""
    n = x.shape[0]
    if _indexed_step(cfg, x):
        with tracing.span("repro_torch.fit.train_pass"):
            f, g = _train_pass_indexed(cfg, state, x, y, idx_i, idx_j)
        with tracing.span("repro_torch.fit.update"):
            state = apply_update(cfg, state, idx_j, g)
            return _maybe_correct(cfg, state, x, y, f, pc, cfg.n_expand,
                                  idx_i)
    with tracing.span("repro_torch.fit.train_pass"):
        xi, yi = x[idx_i], y[idx_i]
        f, g = _grad_block_with_f(cfg, xi, yi, x[idx_j], state.alpha[idx_j],
                                  scale_n(cfg, n))
    with tracing.span("repro_torch.fit.update"):
        state = apply_update(cfg, state, idx_j, g)
        return _maybe_correct(cfg, state, xi, yi, f, pc, cfg.n_expand)


# ---------------------------------------------------------------------------
# Algorithm 2 — parallel shared-memory variant.
# ---------------------------------------------------------------------------

def _grad_block_parallel_with_f(cfg: DSEKLConfig, xi: Tensor, yi: Tensor,
                                xjk: Tensor, ajk: Tensor, n: int
                                ) -> Tuple[Tensor, Tensor]:
    """``grad_block_parallel``'s body, also returning f_I."""
    if cfg.fuse_dual_pass:
        # sum_k K_{I,J^k} a_{J^k} == K_{I,J_union} @ a_union: the worker
        # axis flattens into ONE train pass over the J union, each K tile
        # evaluated once for f and g.
        return _fused_f_and_grad(cfg, xi, yi, xjk.reshape(-1, xjk.shape[-1]),
                                 ajk.reshape(-1), n)
    # The two-pass form: each worker's matvec, f summed over the workers
    # (the "in parallel on worker k" of Alg. 2), then each worker's vecmat.
    f = torch.stack([_block_f(cfg, xi, xj, aj, n)
                     for xj, aj in zip(xjk, ajk)]).sum(0)
    if cfg.unbiased_scaling:            # _block_f scaled by n/j; want n/(K*j)
        f = f / xjk.shape[0]
    v = losses_lib.get_loss(cfg.loss).grad_f(f, yi)
    g = torch.cat([_block_grad(cfg, xi, xj, aj, v)
                   for xj, aj in zip(xjk, ajk)])
    return f, g


def grad_block_parallel(cfg: DSEKLConfig, xi: Tensor, yi: Tensor,
                        xjk: Tensor, ajk: Tensor, n: int = 0) -> Tensor:
    """Alg.-2 dual gradient for one gathered I-batch against K gathered
    worker expansion blocks: xi (n_grad, D), yi (n_grad,), xjk (K, j, D),
    ajk (K, j).  Returns the flat (K*j,) gradient (incl. lam*alpha_J) in
    worker order.  ``n`` is read only under ``cfg.unbiased_scaling``."""
    _, g = _grad_block_parallel_with_f(cfg, xi, yi, xjk, ajk, n)
    return g


def apply_update_parallel(cfg: DSEKLConfig, state: DSEKLState,
                          flat_j: Tensor, flat_g: Tensor) -> DSEKLState:
    """Alg.-2 state update for one flat (K*j,) block gradient, out of
    place: Alg. 2 lines 11 and 14 are Alg. 1's scatter over the J union,
    and the accumulator G_jj is touched only under ``schedule="adagrad"``.
    A step's worker batches are disjoint, so ``index_add`` meets no
    duplicate index (on the card its sums take a fixed order)."""
    return apply_update(cfg, state, flat_j, flat_g)


def grad_block_parallel_precond(cfg: DSEKLConfig, xi: Tensor, yi: Tensor,
                                xjk: Tensor, ajk: Tensor, pc: PrecondBlock,
                                n: int = 0) -> Tuple[Tensor, Tensor]:
    """``grad_block_parallel`` plus the EigenPro correction (|J| =
    n_workers * n_expand): (flat g, delta)."""
    f, flat_g = _grad_block_parallel_with_f(cfg, xi, yi, xjk, ajk, n)
    return flat_g, _delta(cfg, xi, yi, f, pc, cfg.n_workers * cfg.n_expand)


def apply_update_parallel_precond(cfg: DSEKLConfig, state: DSEKLState,
                                  flat_j: Tensor, flat_g: Tensor,
                                  idx_p: Tensor, delta: Tensor
                                  ) -> DSEKLState:
    """Alg.-2 scatter, then the EigenPro correction's."""
    return _apply_correction(
        cfg, apply_update_parallel(cfg, state, flat_j, flat_g), idx_p, delta)


def _parallel_inner(cfg: DSEKLConfig, state: DSEKLState, x: Tensor,
                    y: Tensor, idx_i: Tensor, idx_jk: Tensor,
                    pc: Optional[PrecondBlock] = None) -> DSEKLState:
    """One Alg.-2 step: the gradient batch ``idx_i`` (n_grad,) against the
    K worker batches ``idx_jk`` (K, j), x (N, D) and y (N,) on the state's
    device.

    On the CUDA backend the fused step hands ``idx_i`` and the flat J
    union to ``ops.kernel_train_pass_indexed``: one train-pass launch that
    reads the rows by index for a union of up to 4,096 columns (the sm90
    route; 4 workers x 1,024 at the paper's protocol).  A wider union takes
    the fp32 route, which gathers the rows before it, and above
    ``block.STASH_BUDGET`` falls back to matvec then vecmat.  Every other
    path gathers the blocks and runs ``grad_block_parallel``'s body.  A
    ``PrecondBlock`` adds the EigenPro correction, as in ``step_serial``."""
    n = x.shape[0]
    flat_j = idx_jk.reshape(-1)
    j_union = cfg.n_workers * cfg.n_expand
    if _indexed_step(cfg, x):
        with tracing.span("repro_torch.fit.train_pass"):
            f, g = _train_pass_indexed(cfg, state, x, y, idx_i, flat_j)
        with tracing.span("repro_torch.fit.update"):
            state = apply_update_parallel(cfg, state, flat_j, g)
            return _maybe_correct(cfg, state, x, y, f, pc, j_union, idx_i)
    with tracing.span("repro_torch.fit.train_pass"):
        xi, yi = x[idx_i], y[idx_i]
        f, g = _grad_block_parallel_with_f(cfg, xi, yi, x[idx_jk],
                                           state.alpha[idx_jk],
                                           scale_n(cfg, n))
    with tracing.span("repro_torch.fit.update"):
        state = apply_update_parallel(cfg, state, flat_j, g)
        return _maybe_correct(cfg, state, xi, yi, f, pc, j_union)


def epoch_parallel(cfg: DSEKLConfig, state: DSEKLState, x: Tensor,
                   y: Tensor, i_batches: Tensor, idx_jk: Tensor,
                   pc: Optional[PrecondBlock] = None) -> DSEKLState:
    """One Alg.-2 epoch on the plan ``(i_batches (Bi, n_grad), idx_jk (Bi,
    K, n_expand))`` (``sampler.parallel_epoch_plan``), int64 indices on
    the state's device: one ``_parallel_inner`` per gradient batch (with
    the EigenPro correction when ``pc`` is given)."""
    state = state._replace(epoch=state.epoch + 1)
    for b in range(i_batches.shape[0]):
        with tracing.span("repro_torch.fit.step"):
            state = _parallel_inner(cfg, state, x, y, i_batches[b],
                                    idx_jk[b], pc)
    return state


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


def decision_function_source(cfg: DSEKLConfig, alpha: Tensor, source,
                             x_test: Tensor, chunk: int = 4096) -> Tensor:
    """f(x_test) with the train set streamed from a host-resident
    ``DataSource``, on ``x_test``'s device: each ``chunk``-row slice is
    copied out of the source (numpy / np.memmap) and consumed by one
    matvec, so the train set never becomes device-resident (peak device
    memory O(|test| * chunk) plus one chunk of rows).  A ragged final
    chunk is zero-padded to the full chunk shape, zero alpha on the
    padding, when there is more than one chunk."""
    n = source.n
    dev = x_test.device
    out = torch.zeros((x_test.shape[0],), dtype=torch.float32, device=dev)
    alpha = alpha.to(device=dev, dtype=torch.float32)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        # gather_x copies a slice out of the mapping: the tensor owns it.
        xs = torch.from_numpy(source.gather_x(slice(start, stop))).to(dev)
        al = alpha[start:stop]
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
