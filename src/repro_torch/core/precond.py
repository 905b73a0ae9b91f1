"""EigenPro preconditioning for doubly stochastic steps (port of
``repro/core/precond.py``; DESIGN.md §10).

The dual update scatters g_J = K_{I,J}^T v + lam a_J, and the model read
back is f = K alpha, so the error dynamics pass through K twice: the
full-batch operator is K^2, whose top eigenvalue mu_1 = lambda_1(K)^2 caps
the stable step size.  EigenPro damps the top-k eigendirections of every
step so the step size can grow toward ~2/mu_{k+1}.  The correction is built
from the exact spectrum of the squared Nystrom operator:

    G     = K[:, P]                (n, m) columns at the m subsample rows
    B     = G^T G                  (m, m), ONE streamed pass over the data
    Khat2 = G K_PP^+ B K_PP^+ G^T  the square of the Nystrom kernel

Khat2's nonzero eigenpairs (mu_i, z_i = G u_i) come from one m x m
symmetric eigensolve of B^{1/2} K_PP^+ B K_PP^+ B^{1/2}, and the step
cancels C = G [U_k diag(q) U_k^T] G^T with

    q_i = safety * (1 - (mu_{k+1}/mu_i)^rho) * mu_i / n,

times the step's J-union size |J| at the call site (``core/dsekl.py``).

This module owns the one-time estimate:

  * ``estimate_preconditioner`` draws m rows (from a ``torch.Generator``,
    or takes explicit ``indices``), evaluates K_PP, streams B = G^T G over
    the data in 4,096-row chunks on the device (G in float32 by
    ``kops.kernel_block``, B accumulated in float64), and solves the m x m
    problems on the host in float64 (``eigensystem``).  Only m rows and
    one linear scan leave the data, so it works out of core: the data may
    be a tensor, an array or a ``DataSource``, and the same rows give the
    same bits whichever holds them.
  * ``EigenProPreconditioner`` holds the result as numpy arrays with the
    spectral summary and the step-size rule; ``block(device)`` stages the
    ``dsekl.PrecondBlock`` the steps consume, and ``to_extra`` /
    ``from_extra`` round-trip through a checkpoint's JSON ``extra`` bit for
    bit (float32 -> float -> float32 is lossless).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dsekl
from repro_torch.core.dsekl import DSEKLConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dsekl import ops as kops

Tensor = torch.Tensor

# Fraction of the head cancelled.  Khat2 - C >= 0 holds exactly, but the
# true operator K^2 = Khat2 + (K^2 - Khat2) has an indefinite Nystrom
# remainder; cancelling 95% of the head keeps the corrected spectrum clear
# of its negative dips.
_SAFETY = 0.95

# Step-size margin of the auto rule, as in the EigenPro reference code.
_LR_MARGIN = 0.95

# Rows of one chunk of the streamed B = G^T G pass.
_CHUNK = 4096


@dataclasses.dataclass(frozen=True)
class EigenProPreconditioner:
    """Top-k eigensystem of the squared Nystrom operator + step-size rule.

    indices (m,) int64   — row ids of the Nystrom subsample P, ascending;
    rows (m, D) f32      — the subsample rows;
    vectors (m, k) f32   — U_k, B-orthonormal (z_i = G u_i are the unit
                           eigenvectors of Khat2);
    damping (k,) f32     — q_i = safety (1 - (mu_{k+1}/mu_i)^rho) mu_i / n
                           (per unit of J; the step multiplies by its
                           J-union size);
    eigenvalues (k+1,)   — mu_1 >= ... >= mu_{k+1} of Khat2 (float64);
    n                    — rows of the data the estimate was built from;
    damping_power        — rho of the recipe;
    safety               — fraction of the head cancelled.
    """
    indices: np.ndarray
    rows: np.ndarray
    vectors: np.ndarray
    damping: np.ndarray
    eigenvalues: np.ndarray
    n: int
    damping_power: float
    safety: float

    @property
    def k(self) -> int:
        return int(self.vectors.shape[1])

    @property
    def m(self) -> int:
        return int(self.rows.shape[0])

    def damped_top(self) -> float:
        """Largest eigenvalue of the corrected operator Khat2 - C: the
        largest damped head mode (1 - safety (1 - (mu_t/mu_i)^rho)) mu_i,
        or the undamped tail mu_{k+1}."""
        mu = self.eigenvalues
        tail = float(mu[-1])
        d = (tail / mu[:-1]) ** self.damping_power
        head = float(np.max((1.0 - self.safety * (1.0 - d)) * mu[:-1]))
        return max(tail, head)

    @property
    def scale(self) -> float:
        """mu_1 / damped_top: how much larger a step the corrected
        spectrum admits."""
        return float(self.eigenvalues[0]) / self.damped_top()

    def step_size(self, j_union: int) -> float:
        """Auto lr0 of a preconditioned fit whose steps scatter ``j_union``
        expansion coordinates (Algorithm 1: n_expand; Algorithm 2:
        n_workers * n_expand): margin * 2 n / (j_union * damped_top)."""
        return _LR_MARGIN * 2.0 * self.n / (max(int(j_union), 1)
                                            * self.damped_top())

    def baseline_step_size(self, j_union: int) -> float:
        """The same rule at the undamped mu_1: the largest stable lr0 of
        the plain step, the baseline a preconditioned fit is held
        against."""
        return _LR_MARGIN * 2.0 * self.n / (max(int(j_union), 1)
                                            * float(self.eigenvalues[0]))

    def block(self, device: torch.device) -> dsekl.PrecondBlock:
        """The ``dsekl.PrecondBlock`` the steps consume, on ``device``."""
        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        return dsekl.PrecondBlock(
            rows=f32(self.rows), vectors=f32(self.vectors),
            damping=f32(self.damping),
            indices=torch.tensor(np.asarray(self.indices, np.int64),
                                 device=device))

    def to_extra(self) -> Dict[str, Any]:
        """JSON-ready dict for a checkpoint's ``extra``: float32 values
        survive the float64 JSON round trip bit for bit, so a resumed fit
        replays the same correction."""
        return {
            "indices": np.asarray(self.indices).tolist(),
            "rows": np.asarray(self.rows, np.float32).tolist(),
            "vectors": np.asarray(self.vectors, np.float32).tolist(),
            "damping": np.asarray(self.damping, np.float32).tolist(),
            "eigenvalues": np.asarray(self.eigenvalues,
                                      np.float64).tolist(),
            "n": int(self.n),
            "damping_power": float(self.damping_power),
            "safety": float(self.safety),
        }

    @classmethod
    def from_extra(cls, extra: Dict[str, Any]) -> "EigenProPreconditioner":
        return cls(
            indices=np.asarray(extra["indices"], np.int64),
            rows=np.asarray(extra["rows"], np.float32),
            vectors=np.asarray(extra["vectors"], np.float32),
            damping=np.asarray(extra["damping"], np.float32),
            eigenvalues=np.asarray(extra["eigenvalues"], np.float64),
            n=int(extra["n"]),
            damping_power=float(extra["damping_power"]),
            safety=float(extra["safety"]))


def _n_rows(data) -> int:
    return int(data.n) if hasattr(data, "gather_x") else int(data.shape[0])


def _gather_rows(data, idx, device: torch.device) -> Tensor:
    """Rows ``idx`` (an index array or a slice) of a ``DataSource``
    (through ``gather_x``, out of core), a tensor or an array, as float32
    on ``device``."""
    if hasattr(data, "gather_x"):
        rows = torch.from_numpy(data.gather_x(idx))
    elif isinstance(data, torch.Tensor):
        if not isinstance(idx, slice):
            idx = torch.as_tensor(idx, device=data.device)
        rows = data[idx]
    else:
        rows = torch.from_numpy(np.asarray(np.asarray(data)[idx],
                                           np.float32))
    return rows.to(device=device, dtype=torch.float32).contiguous()


def _stream_gram(cfg: DSEKLConfig, data, rows: Tensor, n: int,
                 chunk: int = _CHUNK) -> Tensor:
    """B = G^T G with G = K(X, rows), over ``chunk``-row slices of the data
    in order: G in float32 (``kops.kernel_block``), B accumulated in
    float64, both on ``rows``' device.  One linear pass; O(m^2) resident."""
    m = rows.shape[0]
    b = torch.zeros((m, m), dtype=torch.float64, device=rows.device)
    for lo in range(0, n, chunk):
        xc = _gather_rows(data, slice(lo, min(lo + chunk, n)), rows.device)
        gc = kops.kernel_block(xc, rows, kernel_name=cfg.kernel,
                               kernel_params=cfg.kernel_params).double()
        b += gc.T @ gc
    return b


def eigensystem(kpp: np.ndarray, b: np.ndarray, k: int, rho: float, n: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The float64 algebra of the estimate, on the host: from K_PP (m, m)
    and B = G^T G (m, m), the top k+1 eigenvalues mu of Khat2 = G K_PP^+ B
    K_PP^+ G^T, its generalized eigenvectors U_k (m, k) and the damping q
    (k,).  Khat2's nonzero eigenpairs (mu, z = G u) solve K_PP^+ B K_PP^+
    B u = mu u, symmetrized through B^{1/2}: eigh(B^{1/2} K_PP^+ B K_PP^+
    B^{1/2}) -> w, u = B^{-1/2} w (so ||z||^2 = u^T B u = 1)."""
    kpp = np.asarray(kpp, np.float64)
    b = np.asarray(b, np.float64)
    sp, up = np.linalg.eigh(kpp)
    keep = sp > 1e-10 * max(float(sp[-1]), 1e-30)
    kpp_inv = (up[:, keep] / sp[keep]) @ up[:, keep].T
    sb, qb = np.linalg.eigh(b)
    sb = np.maximum(sb, 1e-12 * max(float(sb[-1]), 1e-30))
    b_half = (qb * np.sqrt(sb)) @ qb.T
    b_ihalf = (qb / np.sqrt(sb)) @ qb.T
    mid = kpp_inv @ b @ kpp_inv
    mu_all, w_all = np.linalg.eigh(b_half @ mid @ b_half)
    mu = np.maximum(mu_all[::-1][:k + 1], 1e-12)
    u = (b_ihalf @ w_all[:, ::-1])[:, :k]
    tail = mu[k]
    q = _SAFETY * (1.0 - (tail / mu[:k]) ** rho) * mu[:k] / n
    return mu, u, q


def estimate_preconditioner(cfg: DSEKLConfig, data,
                            generator: Optional[torch.Generator] = None, *,
                            indices=None, k: Optional[int] = None,
                            m: Optional[int] = None,
                            damping_power: Optional[float] = None,
                            device: DeviceLike = None
                            ) -> Optional[EigenProPreconditioner]:
    """The one-time Nystrom eigensolve -> ``EigenProPreconditioner``.

    ``data`` is a ``DataSource``, an (N, D) tensor or an (N, D) array.  The
    subsample is ``indices`` when given (sorted here), else m rows drawn
    without replacement from ``generator`` (one ``randperm`` on its
    device) and sorted.  ``k`` / ``m`` / ``damping_power`` default to the
    config's fields (``m=0``: min(N, max(4 (k + 1), 512))).  G and B are
    computed on ``device`` (default: a tensor's own device, else
    ``cuda``); the eigensolves run on the host in float64.  Returns
    ``None`` when k <= 0."""
    k = cfg.precondition_k if k is None else int(k)
    if k <= 0:
        return None
    n = _n_rows(data)
    if indices is not None:
        idx = np.sort(np.asarray(indices, np.int64))
        m = idx.shape[0]
    else:
        m = cfg.precondition_m if m is None else int(m)
        if m <= 0:
            m = min(n, max(4 * (k + 1), 512))
        m = min(max(m, k + 2), n)
    if k + 2 > n or k + 2 > m:
        raise ValueError(
            f"precondition_k={k} needs at least k + 2 = {k + 2} rows for "
            f"the Nystrom eigensolve; the data has {n}, the subsample {m}")
    if indices is None:
        if generator is None:
            raise TypeError("estimate_preconditioner needs a "
                            "torch.Generator or explicit indices")
        drawn = torch.randperm(n, generator=generator,
                               device=generator.device)[:m]
        idx = np.sort(drawn.cpu().numpy().astype(np.int64))
    rho = (cfg.precondition_damping if damping_power is None
           else float(damping_power))
    if device is None and isinstance(data, torch.Tensor):
        dev = data.device
    else:
        dev = resolve_device(device)
    rows = _gather_rows(data, idx, dev)
    kpp = kops.kernel_block(rows, rows, kernel_name=cfg.kernel,
                            kernel_params=cfg.kernel_params)
    b = _stream_gram(cfg, data, rows, n)
    mu, u, q = eigensystem(kpp.double().cpu().numpy(), b.cpu().numpy(), k,
                           rho, n)
    return EigenProPreconditioner(
        indices=idx,
        rows=rows.cpu().numpy(),
        vectors=np.asarray(u, np.float32),
        damping=np.asarray(q, np.float32),
        eigenvalues=np.asarray(mu, np.float64),
        n=n,
        damping_power=rho,
        safety=_SAFETY)
