"""Doubly stochastic kernel PCA (port of ``repro/core/kpca.py``): the
paper's idea applied to the spectral setting it cites (kernel PCA,
Schölkopf et al. 1998).

Classical kPCA eigendecomposes the N x N kernel matrix.  Here a doubly
stochastic subspace iteration never forms K: every step samples J
(expansion points), estimates the action (K V) on all N rows from the
J-sampled kernel map, one ``kops.kernel_matvec`` per component (on the
card the hand-written matvec kernel), orthonormalizes it and mixes it
into V with a 1/sqrt(t) step.  ``transform`` projects new points the same
way, over 4,096-row chunks of the training set.

The JAX package draws J and the initial subspace from a key; here they
come from a ``torch.Generator``, and each also takes explicit values
(``step``'s ``idx_j``, ``fit``'s ``plans``, ``init_state``'s ``v0``), which
is how the tests feed both packages the same numbers.  The QR's sign is
fixed by ``sign(diag(R))``, as in JAX, so the two packages' subspaces are
comparable column by column.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import sampler
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dsekl import ops as kops

Tensor = torch.Tensor

TRANSFORM_CHUNK = 4096


@dataclasses.dataclass(frozen=True)
class KPCAConfig:
    n_components: int = 4
    n_grad: int = 256          # |I|
    n_expand: int = 256        # |J|
    kernel: str = "rbf"
    kernel_params: Tuple[Tuple[str, float], ...] = (("gamma", 1.0),)
    lr0: float = 0.5
    impl: str = "auto"


class KPCAState(NamedTuple):
    v: Tensor      # (N, r) dual coefficients of the eigen-subspace
    step: Tensor


def init_state(gen: Optional[torch.Generator], n: int, cfg: KPCAConfig,
               device: DeviceLike = None, *,
               v0: Optional[Tensor] = None) -> KPCAState:
    """V drawn N(0, 1/n) from ``gen`` (on its device), or ``v0`` when
    given; the state on ``device``."""
    dev = resolve_device(device)
    if v0 is None:
        v0 = torch.randn((n, cfg.n_components), generator=gen,
                         device=gen.device) / math.sqrt(n)
    v = torch.as_tensor(v0).to(device=dev, dtype=torch.float32)
    return KPCAState(v=v, step=torch.zeros((), dtype=torch.int32,
                                           device=dev))


def _block_action(cfg: KPCAConfig, xi: Tensor, xj: Tensor, vj: Tensor,
                  n: int) -> Tensor:
    """(K V)_I estimated from expansion block J: (I, r), one matvec per
    component."""
    cols = [kops.kernel_matvec(xi, xj, vj[:, c], kernel_name=cfg.kernel,
                               kernel_params=cfg.kernel_params,
                               impl=cfg.impl)
            for c in range(cfg.n_components)]
    return torch.stack(cols, dim=1) * (n / xj.shape[0])


def _signed_q(m: Tensor) -> Tensor:
    """Q of m's QR with each column's sign fixed by sign(diag(R))."""
    q, r = torch.linalg.qr(m)
    return q * torch.sign(torch.diagonal(r))[None, :]


def step(cfg: KPCAConfig, state: KPCAState, x: Tensor,
         idx_j: Tensor) -> KPCAState:
    """One stochastic subspace-iteration step on the expansion block
    ``idx_j`` (draw it with ``sampler.sample_uniform``): the J-sampled
    action on ALL rows, orthonormalized first (column-wise normalization
    would collapse every column onto the top eigenvector), then mixed into
    V at beta = lr0 / sqrt(t) and orthonormalized again."""
    n = x.shape[0]
    kv = _block_action(cfg, x, x[idx_j], state.v[idx_j], n)   # (N, r)
    q_new = _signed_q(kv)
    t = state.step + 1
    beta = cfg.lr0 / torch.sqrt(torch.clamp_min(t.to(torch.float32), 1.0))
    v = (1.0 - beta) * state.v + beta * q_new
    return KPCAState(v=_signed_q(v), step=t)


def fit(cfg: KPCAConfig, x: Tensor, generator: Optional[torch.Generator],
        n_steps: int = 300, *, plans: Optional[Sequence] = None,
        v0: Optional[Tensor] = None) -> KPCAState:
    """``n_steps`` steps on ``x``'s device; step i runs on ``plans[i]`` when
    given, else on a J drawn from ``generator``."""
    n = x.shape[0]
    state = init_state(generator, n, cfg, x.device, v0=v0)
    for i in range(n_steps):
        idx_j = (plans[i] if plans is not None else sampler.sample_uniform(
            generator, n, cfg.n_expand))
        state = step(cfg, state, x, torch.as_tensor(idx_j).to(x.device))
    return state


def transform(cfg: KPCAConfig, state: KPCAState, x_train: Tensor,
              x: Tensor) -> Tensor:
    """Project new points: K(x, X) V over ``TRANSFORM_CHUNK``-row chunks of
    the training set (no N x M matrix), one matvec per component a
    chunk."""
    n = x_train.shape[0]
    out = torch.zeros((x.shape[0], cfg.n_components), device=x.device)
    for s0 in range(0, n, TRANSFORM_CHUNK):
        xs = x_train[s0:s0 + TRANSFORM_CHUNK]
        vs = state.v[s0:s0 + TRANSFORM_CHUNK]
        cols = [kops.kernel_matvec(x, xs, vs[:, c], kernel_name=cfg.kernel,
                                   kernel_params=cfg.kernel_params,
                                   impl=cfg.impl)
                for c in range(cfg.n_components)]
        out = out + torch.stack(cols, dim=1)
    return out
