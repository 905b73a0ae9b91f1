"""Block coordinate descent over the empirical kernel map (port of
``repro/core/bcd.py``; DESIGN.md §14).

Tu et al., *Large Scale Kernel Learning using Block Coordinate Descent*
(PAPERS.md), solve the regularized empirical-kernel-map system

    (1/2) ||K alpha - y||^2 + (lam * n / 2) alpha^T K alpha

by exact block solves: each round draws a without-replacement coordinate
block J and updates alpha_J by solving the |J| x |J| system

    (K_{J,.} K_{.,J} + lam*n * K_{J,J} + jitter*I) d = K_{J,.} (y - f)
                                                       - lam*n * f_J

where ``f = K alpha`` is the residual decision vector, kept on the
device and updated INCREMENTALLY: after the solve, ``f += K_{.,J} d``.
A round evaluates two streamed passes over ``K_{.,J}`` (the Gram and
right-hand side, then the f update) plus the |J| x |J| diagonal block.

``K_{.,J}`` is never materialized: rows stream through
``kops.kernel_block`` in ``(row_block, |J|)`` tiles, gathered by the
port's ``BlockPrefetcher`` (``trainer.BCDPlan``).  The tile products are
plain GEMMs in full float32 (``kernels.full_fp32_matmul``: cuBLAS with
TF32 off on the card), as JAX computes them outside any Pallas kernel.

Bit-reproducibility across placements: the rows split into ``shards``
contiguous groups, each group's Gram/rhs partial accumulates on its own,
and the partials come to the host and are summed there in fixed group
order (``combine_partials``), so a fit with ``bcd_shards = k`` gives the
same bits however the groups were computed.  The solve is one Cholesky
on the host-combined system (``torch.linalg.cholesky_ex``, the
``JITTER_LADDER`` walked on the host from its ``info``).

On a mesh (``make_mesh_bcd_ops``) each data shard is one row group: its
ranks stream the shard's tiles, keep its residual, and send its partial
home through the slot stack, so a mesh fit equals the serial one with
``bcd_shards = n_data``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.core import distributed
from repro_torch.core.dsekl import DSEKLConfig
from repro_torch.kernels import full_fp32_matmul
from repro_torch.kernels.dsekl import ops as kops

Tensor = torch.Tensor

# Cholesky jitter escalation: multiples of the relative floor
# cfg.bcd_jitter * trace(A)/|J| tried in order until the factorization
# succeeds.  Host-driven, so every placement walks the identical ladder.
JITTER_LADDER = (1.0, 10.0, 100.0, 1e4, 1e6)


def block_size(cfg: DSEKLConfig, n: int) -> int:
    """|J| of one round: cfg.bcd_block, defaulting to n_expand, capped at n."""
    j = int(cfg.bcd_block or cfg.n_expand)
    return min(j, int(n))


def row_block_size(cfg: DSEKLConfig) -> int:
    """Streamed row-tile size: cfg.bcd_row_block, defaulting to n_grad."""
    return int(cfg.bcd_row_block or cfg.n_grad)


def kernel_tile_evals_per_round(n: int, j: int) -> int:
    """Kernel-map entries one BCD round evaluates: two streamed passes
    over K_{.,J} plus the K_{J,J} diagonal block."""
    return 2 * n * j + j * j


def sample_block(gen: torch.Generator, n: int, j: int) -> np.ndarray:
    """Draw the round's coordinate block J WITHOUT replacement from
    ``gen`` (on its device), as host int64 indices.

    With replacement a duplicated coordinate would make the Gram system
    singular and double-scatter its update: the exact solve needs
    distinct columns."""
    perm = torch.randperm(int(n), generator=gen, device=gen.device)
    return perm[: int(j)].cpu().numpy().astype(np.int64)


def row_plan(n: int, shards: int, row_block: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Round-invariant streaming plan over the n rows.

    Rows split into ``shards`` equal contiguous groups (``n % shards``
    must be 0 when shards > 1), each streamed in ``row_block``-row tiles;
    the tail tile clamps to the group's last row and masks the padding,
    so every group has the identical local tile structure.  Returns
    ``idx (shards, blocks, row_block)`` GLOBAL row indices and ``mask
    (blocks, row_block)`` float32 (shared across groups by construction).
    """
    if shards > 1 and n % shards:
        raise ValueError(
            f"bcd row groups need n divisible by shards (n={n}, "
            f"shards={shards})")
    n_loc = n // shards
    blocks = -(-n_loc // row_block)
    local = np.arange(blocks * row_block, dtype=np.int64)
    mask = (local < n_loc).astype(np.float32).reshape(blocks, row_block)
    local = np.minimum(local, n_loc - 1).reshape(blocks, row_block)
    idx = (np.arange(shards, dtype=np.int64)[:, None, None] * n_loc
           + local[None])
    return idx, mask


def combine_partials(parts: np.ndarray) -> np.ndarray:
    """Sum per-group augmented Gram/rhs partials on host in fixed index
    order.

    Host float32 adds in group order are placement-independent: however
    the groups were computed, the sum lands on the same bits."""
    out = parts[0].copy()
    for d in range(1, parts.shape[0]):
        out += parts[d]
    return out


# ---------------------------------------------------------------------------
# Tile cores.  Both products are fixed-shape GEMMs: the Gram AND the rhs
# in one (|J|, rb) x (rb, |J|+1) augmented product, the f update as
# (rb, |J|) x (|J|, 1).
# ---------------------------------------------------------------------------

def _acc_tile(cfg: DSEKLConfig, xi: Tensor, yi: Tensor, xj: Tensor,
              f_rows: Tensor, mask: Tensor) -> Tensor:
    """One (row_block, |J|) tile's augmented Gram/rhs contribution:
    [K_b^T K_b | K_b^T (y_b - f_b)] as a (|J|, |J|+1) block, padding
    rows masked to zero."""
    kb = kops.kernel_block(xi, xj, kernel_name=cfg.kernel,
                           kernel_params=cfg.kernel_params)
    kbm = kb * mask[:, None]
    r = (yi - f_rows) * mask
    aug = torch.cat([kbm, r[:, None]], dim=1)
    with full_fp32_matmul():
        return kbm.T @ aug


def _fupd_tile(cfg: DSEKLConfig, xi: Tensor, xj: Tensor, delta: Tensor,
               mask: Tensor) -> Tensor:
    """Pass-2 tile contribution mask * (K_b @ delta), as a GEMM."""
    kb = kops.kernel_block(xi, xj, kernel_name=cfg.kernel,
                           kernel_params=cfg.kernel_params)
    with full_fp32_matmul():
        return mask * (kb @ delta[:, None])[:, 0]


def split_gram(gb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(|J|, |J|+1) augmented accumulator -> (Gram, rhs-partial)."""
    return np.ascontiguousarray(gb[:, :-1]), np.ascontiguousarray(gb[:, -1])


# ---------------------------------------------------------------------------
# Serial (single-device) round ops, out of place as in JAX.
# ---------------------------------------------------------------------------

def acc_serial(cfg: DSEKLConfig, xi: Tensor, yi: Tensor, xj: Tensor,
               f: Tensor, idx: Tensor, mask: Tensor, gb: Tensor) -> Tensor:
    """Fold one tile into the (|J|, |J|+1) augmented accumulator."""
    return gb + _acc_tile(cfg, xi, yi, xj, f[idx], mask)


def fupd_serial(cfg: DSEKLConfig, xi: Tensor, xj: Tensor, delta: Tensor,
                f: Tensor, idx: Tensor, mask: Tensor) -> Tensor:
    """Pass-2 incremental residual update: f[rows] += K_b @ delta.
    Clamped tail duplicates carry mask 0, so they add exactly nothing."""
    return f.index_add(0, idx, _fupd_tile(cfg, xi, xj, delta, mask))


def scatter_alpha(alpha: Tensor, idx_j: Tensor, delta: Tensor) -> Tensor:
    """alpha_J += delta (J has no duplicates: sample_block)."""
    return alpha.index_add(0, idx_j, delta)


def _chol_solve(cfg: DSEKLConfig, xj: Tensor, g: Tensor, rhs: Tensor,
                lam_n: float, mult: float) -> Tuple[Tensor, bool]:
    """One jitter-ladder attempt on A = G + lam*n*K_JJ + jitter*I.

    ``lam_n`` and ``mult * cfg.bcd_jitter`` are float32 values passed as
    Python scalars (no host-to-device copy).  Returns (delta, ok): ok is
    decided on the host from the factorization's ``info == 0`` and a
    finite delta."""
    kjj = kops.kernel_block(xj, xj, kernel_name=cfg.kernel,
                            kernel_params=cfg.kernel_params)
    a = g + lam_n * kjj
    rel = float(np.float32(mult) * np.float32(cfg.bcd_jitter))
    jitter = rel * (torch.trace(a) / a.shape[0])
    a = a + jitter * torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    chol, info = torch.linalg.cholesky_ex(a)
    delta = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    ok = bool(info == 0) and bool(torch.isfinite(delta).all())
    return delta, ok


def solve_block(cfg: DSEKLConfig, xj: Tensor, g: np.ndarray,
                rhs: np.ndarray, lam_n: float) -> Tuple[Tensor, float]:
    """Solve the round's block system on ``xj``'s device, escalating the
    jitter through ``JITTER_LADDER`` until the Cholesky succeeds.

    ``g`` and ``rhs`` are the host-combined float32 arrays; returns
    ``(delta, the ladder rung's multiple)``."""
    g, rhs = (torch.from_numpy(np.asarray(v, np.float32)).to(xj.device)
              for v in (g, rhs))
    lam = float(np.float32(lam_n))
    for mult in JITTER_LADDER:
        delta, ok = _chol_solve(cfg, xj, g, rhs, lam, mult)
        if ok:
            return delta, mult
    raise RuntimeError(
        "BCD block solve failed: Cholesky not finite at the top of the "
        f"jitter ladder (bcd_jitter={cfg.bcd_jitter!r}; raise it, or "
        "shrink bcd_block)")


# ---------------------------------------------------------------------------
# Mesh round ops: row groups are the data shards, x_J on every rank.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshBCDOps:
    """One rank's cross-rank ops of a mesh BCD round (the tiles are
    ``acc_serial`` / ``fupd_serial`` on the rank's rows)."""
    scatter: Callable     # (alpha_shard, idx_j GLOBAL, delta) -> shard
    partials: Callable    # (gb) -> (n_data, |J|, |J|+1) host array
    f_at: Callable        # (f_loc, idx_j GLOBAL) -> f_J host array


def make_mesh_bcd_ops(mesh) -> MeshBCDOps:
    """The mesh round's cross-rank ops, for the rank at (d, m).  Its data
    shard's tiles (LOCAL rows into its residual f_loc) against x_J from the
    whole source accumulate a private (|J|, |J|+1) partial with the serial
    tile ops, no reduction on the device; ``partials`` brings every data
    shard's home through the slot stack (``distributed.gather_slots``,
    exact) for the host's fixed-order ``combine_partials``; ``f_at`` reads
    f at the global J the same way (each data shard its own entries, the
    rest an exact 0); ``scatter`` adds the replicated solution to the
    entries of J this model shard owns.  So a mesh fit equals the serial
    fit with ``bcd_shards = n_data`` bit for bit on the CPU."""
    d, m = mesh.index(distributed.DATA), mesh.index(distributed.MODEL)

    def scatter(alpha_loc: Tensor, idx_j: Tensor, delta: Tensor) -> Tensor:
        return distributed.scatter_owned(alpha_loc, idx_j, delta,
                                         m * alpha_loc.shape[0])

    def partials(gb: Tensor) -> np.ndarray:
        return distributed.gather_slots(mesh, gb,
                                        distributed.DATA).cpu().numpy()

    def f_at(f_loc: Tensor, idx_j: Tensor) -> np.ndarray:
        rows = f_loc.shape[0]
        local = idx_j - d * rows
        own = (local >= 0) & (local < rows)
        part = torch.where(own, f_loc[torch.where(own, local, 0)], 0.0)
        return distributed._sum(part, mesh,
                                distributed.DATA).cpu().numpy()

    return MeshBCDOps(scatter=scatter, partials=partials, f_at=f_at)
