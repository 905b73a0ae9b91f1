"""Distributed DSEKL on a 2-D (data x model) mesh (port of
``repro/core/distributed.py``; DESIGN.md §2).

One process per mesh coordinate (d, m) of ``launch.mesh.make_local_mesh``
holds

  * its gradient rows X^(d): the data sharded over the ``data`` axis,
  * its expansion rows X^(m): the SAME data sharded over the ``model``
    axis,
  * the alpha / accum shard of its expansion rows (replicated over
    ``data``: every rank of one model column applies the same update).

Each step, rank (d, m) evaluates the kernel block K_{I_d, J_m}; the mesh
jointly covers an (|data| * I) x (|model| * J) block of the full kernel
matrix.  A step communicates two reductions, independent of N and D:

  * an ``all_reduce`` over ``model`` of the partial decision values
    (I * 4 bytes);
  * an ``all_reduce`` over ``data`` of the expansion shard's gradient
    (J * 4 bytes; int32 in the compressed form, ``compress_bits``).

The JAX operations map onto ``torch.distributed`` as ``psum`` ->
``all_reduce(SUM)`` on the axis's group, ``pmax`` -> ``all_reduce(MAX)``,
``axis_index`` -> the mesh coordinate and ``psum(1, axis)`` -> the group's
size.  Gathers that gloo cannot do on CUDA tensors (it reduces and
broadcasts them only) are an ``all_reduce`` of a zero-filled stack of
slots, each rank writing its own (``gather_slots``): exact in float32,
since x + 0 = x.

The step body has three branches, as in JAX: the fused one on the ref
backend (K evaluated once and held across the model reduction), the
streamed one (``cfg.stream_row_block > 0`` on ref: the model reduction per
row block), and the two-pass one (every CUDA fit: the sm90 matvec for f,
then, after the model reduction, the sm90 vecmat for g).

Every function that samples takes its plan explicitly: the whole mesh's
step plan (``sampler.mesh_step_plan``: I per data shard, J per model
shard, LOCAL indices), of which each rank takes its own rows.  Unlike the
JAX package's single controller, which gathers every shard's rows and
places them by sharding, each rank gathers only its own blocks: xi / yi
from ``data_sources[d]`` and xj from ``model_sources[m]``.
``simulate_step`` reproduces the mesh step's math in one process, on the
same plans: the tests' oracle.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import dsekl, losses as losses_lib
from repro_torch.core.dsekl import DSEKLConfig, DSEKLState, PrecondBlock
from repro_torch.distributed import collectives, compression
from repro_torch.kernels import full_fp32_matmul
from repro_torch.kernels.dsekl import ops as kops

Tensor = torch.Tensor
DATA, MODEL = "data", "model"


class ShardedDSEKLState(NamedTuple):
    alpha: Tensor   # (N / n_model,) this rank's model shard
    accum: Tensor   # (N / n_model,) this rank's model shard
    step: Tensor    # () int32, the same on every rank


def _sum(t: Tensor, mesh, axis: str) -> Tensor:
    """``psum``: ``t`` summed over ``axis``'s group, in place (counted in
    ``collectives.COUNTS`` / ``BYTES``)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    collectives.note("psum:all_reduce", t)
    return t


def gather_slots(mesh, t: Tensor, axis: str) -> Tensor:
    """``(size(axis),) + t.shape``: slot i holds the ``t`` of the rank at
    coordinate i on ``axis`` (the others of this rank's coordinates
    fixed), on every rank of the group.  An ``all_reduce`` of zeros with
    this rank's slot filled: exact, and on gloo the only gather a CUDA
    tensor has."""
    out = t.new_zeros((mesh.size(axis),) + tuple(t.shape))
    out[mesh.index(axis)] = t
    return _sum(out, mesh, axis)


def gather_model_shards(mesh, shard: Tensor) -> Tensor:
    """The full (N,) vector of a model-sharded one (alpha, accum)."""
    return gather_slots(mesh, shard, MODEL).reshape(-1)


def broadcast_block(mesh, pc: Optional[PrecondBlock]
                    ) -> Optional[PrecondBlock]:
    """The preconditioner replicated from rank 0 to every rank (in place):
    each rank's copy then holds the same bits."""
    if pc is None:
        return None
    for t in pc:
        dist.broadcast(t, src=0)
    return pc


# ---------------------------------------------------------------------------
# The per-rank step body.
# ---------------------------------------------------------------------------

def _shard_block_grad_v(cfg: DSEKLConfig, n_global: int, xi: Tensor,
                        yi: Tensor, xj: Tensor, aj: Tensor, mesh,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[Tensor, Tensor]:
    """``_shard_block_grad``'s body, also returning this data shard's loss
    gradient v (the preconditioned step's correction needs it).  The model
    reduction must complete before v exists, so the fused form evaluates
    the local block once and holds it across the reduction (ref only);
    ``stream_row_block`` reduces per row block; the CUDA backend runs the
    two-pass form (matvec, reduction, vecmat)."""
    loss = losses_lib.get_loss(cfg.loss)
    n_model = mesh.size(MODEL)
    ref_impl = kops.resolve_impl(cfg.impl, cfg.kernel, xi.device) == "ref"
    fused = cfg.fuse_dual_pass and ref_impl
    if fused and cfg.stream_row_block > 0:
        def f_reduce(f_part):
            f_full = _sum(f_part, mesh, MODEL)
            if cfg.unbiased_scaling:
                f_full = f_full / n_model
            return f_full

        f, g = dsekl.streaming_train_pass(
            cfg, xi, yi, xj, aj, n_global, row_block=cfg.stream_row_block,
            f_reduce=f_reduce)
        v = loss.grad_f(f, yi)
    elif fused:
        kb = kops.kernel_block(xi, xj, kernel_name=cfg.kernel,
                               kernel_params=cfg.kernel_params)
        with full_fp32_matmul():
            f_part = kb @ aj
        if cfg.unbiased_scaling:
            f_part = f_part * (n_global / xj.shape[0])
        f = _sum(f_part, mesh, MODEL)
        if cfg.unbiased_scaling:
            f = f / n_model
        v = loss.grad_f(f, yi)
        with full_fp32_matmul():
            g = kb.T @ v
    else:
        f = _sum(dsekl._block_f(cfg, xi, xj, aj, n_global), mesh, MODEL)
        if cfg.unbiased_scaling:
            f = f / n_model
        v = loss.grad_f(f, yi)
        # The data-dependent part only: summed over every data shard's
        # I-batch, then the regularizer is added ONCE.
        g = dsekl._block_grad(cfg.replace(lam=0.0), xi, xj, aj, v)
    if cfg.compress_bits:
        if generator is None:
            raise ValueError("cfg.compress_bits needs a torch.Generator for "
                             "the stochastic rounding's uniforms")
        g = compression.compressed_all_reduce(
            g, mesh.group(DATA), generator, bits=cfg.compress_bits)
    else:
        g = _sum(g, mesh, DATA)
    return g + cfg.lam * aj, v


def _shard_block_grad(cfg: DSEKLConfig, n_global: int, xi: Tensor,
                      yi: Tensor, xj: Tensor, aj: Tensor, mesh,
                      generator: Optional[torch.Generator] = None) -> Tensor:
    """This rank's dual gradient for ONE gathered (xi, yi, xj, aj) block,
    both reductions complete and the regularizer added once: the mesh
    counterpart of ``dsekl.grad_block``."""
    g, _ = _shard_block_grad_v(cfg, n_global, xi, yi, xj, aj, mesh,
                               generator)
    return g


def _apply_shard_update(cfg: DSEKLConfig, alpha: Tensor, accum: Tensor,
                        step: Tensor, idx_j: Tensor, g: Tensor
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Scatter one shard gradient into the local alpha / accum shard, out
    of place (``index_add``: duplicate J indices add up).  The AdaGrad
    accumulator is touched only under ``schedule="adagrad"``.  The rate
    reads the incremented step t (and t as the epoch, as JAX's does)."""
    t = step + 1
    lr = dsekl._lr(cfg, DSEKLState(alpha, accum, t, t))
    if cfg.schedule == "adagrad":
        accum = accum.index_add(0, idx_j, g * g)
        damp = torch.rsqrt(accum[idx_j])
        alpha = alpha.index_add(0, idx_j, -lr * damp * g)
    else:
        alpha = alpha.index_add(0, idx_j, -lr * g)
    return alpha, accum, t


def scatter_owned(shard: Tensor, idx_global: Tensor, values: Tensor,
                  offset: int) -> Tensor:
    """``shard`` (the rows [offset, offset + len) of a vector) plus
    ``values`` at the entries of ``idx_global`` it owns, out of place.
    JAX drops out-of-bounds scatter updates; ``index_add`` raises on them
    (or writes out of range on the card), so the entries this shard does
    not own add an exact 0.0 at row 0."""
    local = idx_global - offset
    own = (local >= 0) & (local < shard.shape[0])
    return shard.index_add(0, torch.where(own, local, 0),
                           torch.where(own, values, 0.0))


def _local_block_step(cfg: DSEKLConfig, n_global: int, xi: Tensor,
                      yi: Tensor, xj: Tensor, idx_j: Tensor, alpha: Tensor,
                      accum: Tensor, step: Tensor, mesh,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """One rank's step on PRE-GATHERED blocks: its data shard's sampled
    gradient rows (xi, yi), its model shard's expansion rows (xj) and their
    LOCAL indices (idx_j) into its alpha / accum shard."""
    aj = alpha[idx_j]
    g = _shard_block_grad(cfg, n_global, xi, yi, xj, aj, mesh, generator)
    return _apply_shard_update(cfg, alpha, accum, step, idx_j, g)


def _local_block_step_precond(cfg: DSEKLConfig, n_global: int, xi: Tensor,
                              yi: Tensor, xj: Tensor, idx_j: Tensor,
                              alpha: Tensor, accum: Tensor, step: Tensor,
                              pc: PrecondBlock, mesh,
                              generator: Optional[torch.Generator] = None
                              ) -> Tuple[Tensor, Tensor, Tensor]:
    """``_local_block_step`` plus the EigenPro correction (DESIGN.md §10),
    the preconditioner replicated on every rank, its indices GLOBAL:

        c = K_{P, I_all} @ v_all = sum over data of K_{P, I_d} @ v_d
        delta = V (q * (V^T c))                                  # (m,)

    is the same on every rank after the data reduction, so each model
    shard scatters the entries of delta it owns (``scatter_owned``), after
    the main update, at the step's scalar rate."""
    aj = alpha[idx_j]
    g, v = _shard_block_grad_v(cfg, n_global, xi, yi, xj, aj, mesh,
                               generator)
    c = kops.kernel_vecmat(xi, pc.rows, v, kernel_name=cfg.kernel,
                           kernel_params=cfg.kernel_params, impl=cfg.impl)
    c = _sum(c, mesh, DATA)
    # The step's J union: every model shard scatters its own n_expand.
    j_union = xj.shape[0] * mesh.size(MODEL)
    with full_fp32_matmul():
        delta = pc.vectors @ ((float(j_union) * pc.damping)
                              * (pc.vectors.T @ c))
    alpha, accum, t = _apply_shard_update(cfg, alpha, accum, step, idx_j, g)
    lr = dsekl._lr(cfg, DSEKLState(alpha, accum, t, t))
    rows_m = alpha.shape[0]
    alpha = scatter_owned(alpha, pc.indices, lr * delta,
                          mesh.index(MODEL) * rows_m)
    return alpha, accum, t


def _local_step(cfg: DSEKLConfig, n_global: int, x_grad: Tensor,
                y_grad: Tensor, x_exp: Tensor, alpha: Tensor, accum: Tensor,
                step: Tensor, idx_i: Tensor, idx_j: Tensor, mesh,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """One rank's step on device-resident shards: the mesh's step plan
    ``idx_i (n_data, n_grad)`` / ``idx_j (n_model, n_expand)`` (LOCAL
    indices), of which this rank gathers its own rows."""
    d, m = mesh.index(DATA), mesh.index(MODEL)
    ii = idx_i[d].to(device=x_grad.device, dtype=torch.int64)
    jj = idx_j[m].to(device=x_exp.device, dtype=torch.int64)
    return _local_block_step(cfg, n_global, x_grad[ii], y_grad[ii],
                             x_exp[jj], jj, alpha, accum, step, mesh,
                             generator)


def make_distributed_step(cfg: DSEKLConfig, mesh, n_global: int):
    """The step on device-resident shards (``shard_inputs``):
    ``step(x_grad, y_grad, x_exp, state, plan, generator=None) -> state``,
    ``plan = (idx_i (n_data, n_grad), idx_j (n_model, n_expand))``.
    ``generator`` draws the compressed reduction's uniforms."""
    def step(x_grad, y_grad, x_exp, state: ShardedDSEKLState, plan,
             generator: Optional[torch.Generator] = None):
        idx_i, idx_j = plan
        return ShardedDSEKLState(*_local_step(
            cfg, n_global, x_grad, y_grad, x_exp, state.alpha, state.accum,
            state.step, idx_i, idx_j, mesh, generator))

    return step


def make_distributed_block_step(cfg: DSEKLConfig, mesh, n_global: int,
                                precondition: bool = False):
    """The step on PRE-GATHERED blocks (the out-of-core mesh data plane,
    DESIGN.md §8): ``step(xi (n_grad, D), yi (n_grad,), xj (n_expand, D),
    idx_j (n_expand,) LOCAL, state, [pc,] generator=None) -> state``, the
    blocks on this rank's device (``MeshPrefetcher`` stages them there).
    With ``precondition=True`` it takes the replicated ``PrecondBlock``
    (GLOBAL indices) and adds the EigenPro correction: one more (m,)
    reduction over data a step."""
    if precondition:
        def step_pc(xi, yi, xj, idx_j, state: ShardedDSEKLState,
                    pc: PrecondBlock,
                    generator: Optional[torch.Generator] = None):
            return ShardedDSEKLState(*_local_block_step_precond(
                cfg, n_global, xi, yi, xj, idx_j, state.alpha, state.accum,
                state.step, pc, mesh, generator))

        return step_pc

    def step(xi, yi, xj, idx_j, state: ShardedDSEKLState,
             generator: Optional[torch.Generator] = None):
        return ShardedDSEKLState(*_local_block_step(
            cfg, n_global, xi, yi, xj, idx_j, state.alpha, state.accum,
            state.step, mesh, generator))

    return step


# ---------------------------------------------------------------------------
# Gathers, eval and placement.
# ---------------------------------------------------------------------------

def gather_mesh_blocks_from(idx_i_np, idx_j_np, data_sources, model_sources,
                            coord: Tuple[int, int]):
    """Rank ``coord = (d, m)``'s blocks of ONE step of a mesh plan
    (``idx_i (n_data, n_grad)`` / ``idx_j (n_model, n_expand)``, LOCAL
    indices): ``(xi, yi, xj, idx_j_local)`` as host arrays, read from
    ``data_sources[d]`` and ``model_sources[m]`` only (the JAX function
    gathers every shard's rows and concatenates them in shard order)."""
    d, m = coord
    ii = np.asarray(idx_i_np)[d]
    jj = np.asarray(idx_j_np)[m]
    xi, yi = data_sources[d].gather(ii)
    xj = model_sources[m].gather_x(jj)
    return xi, yi, xj, np.ascontiguousarray(jj)


def gather_mesh_blocks(cfg: DSEKLConfig, generator: torch.Generator,
                       data_sources, model_sources, coord: Tuple[int, int]):
    """Plan ONE step from ``generator`` (``sampler.mesh_step_plan``) and
    gather rank ``coord``'s blocks of it."""
    from repro_torch.core import sampler
    idx_i, idx_j = sampler.mesh_step_plan(
        generator, cfg.n_grad, cfg.n_expand,
        tuple(s.n for s in data_sources), tuple(s.n for s in model_sources))
    return gather_mesh_blocks_from(idx_i.cpu().numpy(), idx_j.cpu().numpy(),
                                   data_sources, model_sources, coord)


def make_mesh_eval(cfg: DSEKLConfig, mesh, chunk: int = 2048):
    """The validation decision function of a mesh fit:
    ``eval_fn(alpha_shard, model_sources, x_test) -> f (|test|,)`` on every
    rank.  Each rank streams its model shard's expansion rows ``chunk`` at
    a time from its host-resident source, one matvec a chunk against its
    alpha shard, and the chunk's partials are summed over ``model`` by ONE
    |test|-float ``all_reduce``: the training step's f reduction."""
    def eval_fn(alpha: Tensor, model_sources: Sequence, x_test: Tensor
                ) -> Tensor:
        src = model_sources[mesh.index(MODEL)]
        dev = x_test.device
        out = torch.zeros((x_test.shape[0],), dtype=torch.float32,
                          device=dev)
        for start in range(0, src.n, chunk):
            stop = min(start + chunk, src.n)
            xs = torch.from_numpy(src.gather_x(slice(start, stop))).to(dev)
            f_part = kops.kernel_matvec(
                x_test, xs, alpha[start:stop], kernel_name=cfg.kernel,
                kernel_params=cfg.kernel_params, impl=cfg.impl)
            out = out + _sum(f_part, mesh, MODEL)
        return out

    return eval_fn


def shard_inputs(mesh, x: Tensor, y: Tensor):
    """This rank's rows of the redundant distribution, on its device:
    ``(x_grad, y_grad)`` its data shard, ``x_exp`` its model shard."""
    n = x.shape[0]
    rd, rm = n // mesh.size(DATA), n // mesh.size(MODEL)
    d, m = mesh.index(DATA), mesh.index(MODEL)
    dev = mesh.device
    return (x[d * rd:(d + 1) * rd].to(dev), y[d * rd:(d + 1) * rd].to(dev),
            x[m * rm:(m + 1) * rm].to(dev))


def init_sharded_state(mesh, n: int) -> ShardedDSEKLState:
    rows = n // mesh.size(MODEL)
    dev = mesh.device
    return ShardedDSEKLState(
        alpha=torch.zeros((rows,), dtype=torch.float32, device=dev),
        accum=torch.ones((rows,), dtype=torch.float32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev))


def state_shard(mesh, full: Tensor) -> Tensor:
    """This rank's model shard of a full (N,) vector."""
    rows = full.shape[0] // mesh.size(MODEL)
    m = mesh.index(MODEL)
    return full[m * rows:(m + 1) * rows]


# ---------------------------------------------------------------------------
# Single-process simulation (the tests' oracle for the mesh step).
# ---------------------------------------------------------------------------

def simulate_step(cfg: DSEKLConfig, n_data_shards: int, n_model_shards: int,
                  x: Tensor, y: Tensor, alpha: Tensor, accum: Tensor,
                  step: Tensor, idx_i: Tensor, idx_j: Tensor,
                  pc: Optional[PrecondBlock] = None
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """The mesh step's math in one process, looping over the shards, on
    the step plan ``idx_i (n_data, n_grad)`` / ``idx_j (n_model,
    n_expand)`` of LOCAL indices.  ``pc`` adds the EigenPro correction:
    the model shards' owned scatters of the replicated delta compose to
    ONE scatter at ``pc.indices``."""
    n = x.shape[0]
    loss = losses_lib.get_loss(cfg.loss)
    rows_d, rows_m = n // n_data_shards, n // n_model_shards
    dev = x.device
    ii = [idx_i[d].to(device=dev, dtype=torch.int64) + d * rows_d
          for d in range(n_data_shards)]
    jj = [idx_j[m].to(device=dev, dtype=torch.int64) + m * rows_m
          for m in range(n_model_shards)]
    # f per data shard: the model reduction is the sum over the J shards.
    vs = []
    for d in range(n_data_shards):
        f = torch.zeros((idx_i.shape[1],), dtype=torch.float32, device=dev)
        for m in range(n_model_shards):
            f = f + dsekl._block_f(cfg, x[ii[d]], x[jj[m]], alpha[jj[m]], n)
        if cfg.unbiased_scaling:
            f = f / n_model_shards
        vs.append(loss.grad_f(f, y[ii[d]]))
    t = step + 1
    new_alpha, new_accum = alpha, accum
    lr = dsekl._lr(cfg, DSEKLState(alpha, accum, t, t))
    cfg0 = cfg.replace(lam=0.0)
    for m in range(n_model_shards):
        aj = alpha[jj[m]]
        g = torch.zeros((idx_j.shape[1],), dtype=torch.float32, device=dev)
        for d in range(n_data_shards):
            g = g + dsekl._block_grad(cfg0, x[ii[d]], x[jj[m]], aj, vs[d])
        g = g + cfg.lam * aj          # the regularizer once, as on the mesh
        if cfg.schedule == "adagrad":
            new_accum = new_accum.index_add(0, jj[m], g * g)
            damp = torch.rsqrt(new_accum[jj[m]])
            new_alpha = new_alpha.index_add(0, jj[m], -lr * damp * g)
        else:
            new_alpha = new_alpha.index_add(0, jj[m], -lr * g)
    if pc is not None:
        c = torch.zeros((pc.rows.shape[0],), dtype=torch.float32, device=dev)
        for d in range(n_data_shards):
            c = c + kops.kernel_vecmat(x[ii[d]], pc.rows, vs[d],
                                       kernel_name=cfg.kernel,
                                       kernel_params=cfg.kernel_params,
                                       impl=cfg.impl)
        j_union = n_model_shards * idx_j.shape[1]
        with full_fp32_matmul():
            delta = pc.vectors @ ((float(j_union) * pc.damping)
                                  * (pc.vectors.T @ c))
        new_alpha = new_alpha.index_add(0, pc.indices, lr * delta)
    return new_alpha, new_accum, t
