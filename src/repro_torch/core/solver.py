"""Training front door for DSEKL: ``fit`` and ``train_epoch_hosted`` (port
of ``repro/core/solver.py``).

The paper's stopping rule (§4.2): stop when the L2 norm of the dual
coefficients' change over one epoch is below ``tol``.  ``fit`` resolves
the data placement and the requested execution to a backend
(``trainer.resolve_execution``):

  * ``SerialPlan`` / ``ParallelPlan`` — Algorithm 1 / 2 on tensors held on
    the device;
  * ``HostedPlan`` — either algorithm over a host-resident ``DataSource``
    (numpy / ``np.memmap``): the plans replayed through one cross-epoch
    ``BlockPrefetcher``, bit-identical to the in-memory fit on the CPU;
  * ``BCDPlan`` — block coordinate descent rounds over a ``DataSource``
    (arrays are wrapped in an ``InMemorySource``): exact block solves of
    the square-loss system, ``execution="bcd"``, serially or on a mesh;
  * ``MeshPlan`` — the 2-D (data x model) mesh of ``torch.distributed``
    ranks, ``execution="mesh"`` (or a ``mesh=``): the doubly stochastic
    step of ``core/distributed.py`` on every rank;

and drives ``trainer.fit_loop``: epoch -> truncate -> eval -> snapshot,
with checkpoint/resume through ``checkpoint.CheckpointManager``.  EigenPro
preconditioning (``precondition=`` or ``cfg.precondition_k``) is estimated
once before the loop (``core/precond.py``) and rides on every stochastic
backend.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import trainer
from repro_torch.core.dsekl import DSEKLConfig, DSEKLState
from repro_torch.core.trainer import (  # noqa: F401  (re-exported API)
    BCDPlan, ExecutionPlan, FitResult, HostedPlan, MeshPlan, ParallelPlan,
    SerialPlan, _EVAL_CACHE_BUDGET_BYTES, _error,
)
from repro_torch.data.source import DataSource, InMemorySource, RingSource
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


def _f32_on(t, device: torch.device) -> Tensor:
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.asarray(t))
    return t.to(device=device, dtype=torch.float32)


def train_epoch_hosted(cfg: DSEKLConfig, state: DSEKLState, source, plan, *,
                       algorithm: str = "serial", prefetch: bool = True,
                       stats: Optional[dict] = None,
                       device: DeviceLike = None) -> DSEKLState:
    """One out-of-core epoch over a host-resident source on the index plan
    ``plan`` (``trainer.HostedPlan.draw_plan`` draws one): the per-epoch
    building block ``fit`` drives, for A/B runs of the prefetcher against
    the inline gather (``prefetch=False``).  ``state`` lives on ``device``
    (default ``cuda``).  Equal to one epoch of a hosted ``fit`` on the
    same plan; ``stats`` accumulates the loader's counters."""
    with trainer.HostedPlan(cfg, source, algorithm=algorithm,
                            prefetch=prefetch,
                            device=resolve_device(device)) as plan_:
        state = plan_.run_epoch(state, plan)
        if stats is not None:
            for k, v in (plan_.loader_stats() or {}).items():
                stats[k] = stats.get(k, 0.0) + v
    return state


# The tag that derives the estimate's generator from the fit's: the
# estimate never draws from the fit's generator, so a preconditioned fit
# and a plain one draw identical epochs (the JAX fit folds this tag into
# its key).
_PRECOND_KEY_TAG = 1337


def _precond_generator(generator: torch.Generator) -> torch.Generator:
    """A CPU generator for the estimate's subsample, seeded from the fit
    generator's initial seed and ``_PRECOND_KEY_TAG``; ``generator``
    itself is left untouched."""
    seed = (generator.initial_seed() * 0x9E3779B97F4A7C15
            + _PRECOND_KEY_TAG) % (1 << 63)
    return torch.Generator().manual_seed(seed)


def _wants_preconditioner(cfg: DSEKLConfig, precondition) -> bool:
    """Whether ``fit``'s ``precondition=`` (with ``cfg.precondition_k``)
    asks for EigenPro: a built preconditioner, or a rank above 0."""
    if hasattr(precondition, "block"):
        return True
    k = cfg.precondition_k if precondition is None else int(precondition)
    return k > 0


def _resolve_preconditioner(cfg: DSEKLConfig, precondition, data,
                            generator: Optional[torch.Generator], *,
                            manager, resume: bool, device: torch.device):
    """``fit``'s ``precondition=``: an ``EigenProPreconditioner`` passes
    through; otherwise the rank (``None``: ``cfg.precondition_k``; 0:
    off) is restored from the newest checkpoint's ``extra["precond"]`` on
    resume, else estimated from ``data`` on ``device`` with a generator
    derived from ``generator``.  Returns ``(preconditioner or None,
    seconds the estimate took)``."""
    if hasattr(precondition, "block"):
        return precondition, 0.0
    if not _wants_preconditioner(cfg, precondition):
        return None, 0.0
    k = cfg.precondition_k if precondition is None else int(precondition)
    from repro_torch.core import precond as precond_lib
    if manager is not None and resume:
        step = manager.latest_valid_step()
        if step is not None:
            _, _, extra = manager.restore(step)
            if "precond" in extra:
                # Bit-exact: the resumed correction replays the
                # interrupted fit's.
                return precond_lib.EigenProPreconditioner.from_extra(
                    extra["precond"]), 0.0
    if generator is None:
        raise ValueError(
            "a preconditioned fit on explicit plans= needs a built "
            "EigenProPreconditioner (precondition=estimate_preconditioner("
            "...)): without a generator there is nothing to draw the "
            "Nystrom subsample from")
    t0 = time.perf_counter()
    pre = precond_lib.estimate_preconditioner(
        cfg, data, _precond_generator(generator), k=k, device=device)
    return pre, time.perf_counter() - t0


def fit(cfg: DSEKLConfig, x, y=None,
        generator: Optional[torch.Generator] = None, *,
        plans: Optional[Sequence] = None, execution: Optional[str] = None,
        algorithm: str = "serial", n_epochs: int = 50, tol: float = 1e-3,
        x_val=None, y_val=None, eval_every: int = 1, verbose: bool = False,
        truncate_every: int = 0, truncate_frac: float = 0.1,
        eval_cache="auto", prefetch: bool = True,
        checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
        checkpoint_keep: int = 3, resume: bool = False,
        callback: Optional[Callable[[int, DSEKLState], None]] = None,
        precondition=None, on_epoch=None, mesh=None,
        device: DeviceLike = None) -> FitResult:
    """Run DSEKL until convergence (paper stopping rule) or ``n_epochs``.

    ``x`` is either the ``(N, D)`` rows (a tensor or an array, with ``y``)
    or a ``DataSource`` (with ``y=None``: the labels are the source's).
    ``execution`` picks the backend (default ``cfg.execution``, normally
    ``"auto"``): arrays or an ``InMemorySource`` go to the device and
    train in memory, by ``algorithm`` (``"serial"``: Algorithm 1,
    ``"parallel"``: Algorithm 2 with ``cfg.n_workers`` workers); a
    ``HostSource`` (numpy / np.memmap) trains out of core
    (``"hosted"``), with the plans streamed through a prefetcher one epoch
    ahead (``prefetch=False`` gathers inline, the A/B baseline) and the
    validation eval streamed from the source.  The state, ``x_val`` and
    ``y_val`` live on ``device`` (default ``cuda``, which raises without a
    card: pass ``device="cpu"`` there).

    Each epoch runs on an index plan drawn from ``generator`` (a
    ``torch.Generator``; the plan is drawn on its device, so a hosted fit
    that keeps the card for its state takes a CPU generator), or on
    ``plans[e]`` when ``plans`` is given: per epoch ``(idx_i (steps,
    n_grad), idx_j (steps, n_expand))`` for Algorithm 1, ``(i_batches
    (steps, n_grad), idx_jk (steps, K, n_expand))`` for Algorithm 2, the
    round's block J ``(|J|,)`` for BCD — how the tests feed both packages
    the JAX sampler's indices.

    ``execution="bcd"`` runs block coordinate descent rounds instead of
    stochastic steps (``trainer.BCDPlan``; square loss only, no
    truncation and no preconditioning, DESIGN.md §14): one epoch is one
    round on a without-replacement block of ``cfg.bcd_block`` coordinates
    (default ``n_expand``) streamed in ``cfg.bcd_row_block``-row tiles
    (default ``n_grad``), in memory (the arrays wrapped in an
    ``InMemorySource``) or from a ``HostSource``; the state lives on
    ``device``.

    ``execution="mesh"`` (or ``mesh=`` a ``launch.mesh.LocalMesh``) trains
    on the 2-D (data x model) mesh, one process a coordinate, each calling
    ``fit`` with the same arguments and the same generator state
    (``trainer.MeshPlan``): the data as a ``DataSource`` split per shard
    (arrays are wrapped in an ``InMemorySource``), the state, ``x_val``
    and ``y_val`` on the rank's mesh device, the epoch plans ``(idx_i
    (steps, n_data, n_grad), idx_j (steps, n_model, n_expand))`` of LOCAL
    indices.  Without ``mesh`` it runs on ``(world, 1)`` over an
    initialised world, else on a world of one that it tears down again.
    ``execution="bcd"`` with ``mesh`` runs the rounds on the mesh.  Rank 0
    alone prints and writes checkpoints, which hold the full vectors, so a
    fit resumes on another mesh shape (the same N).

    A live ``RingSource`` is snapshotted once at entry: appends during the
    fit cannot reach it.

    ``truncate_every``: every k epochs the smallest ``truncate_frac`` of
    non-zero |alpha| mass is zeroed (paper §5's budgeted model).

    ``eval_cache``: evaluate ``x_val`` through a cached keep-all prediction
    engine (the validation kernel map is kept across epochs); ``"auto"``
    turns it on in memory when the n_val x N map fits 1 GiB.

    ``checkpoint_dir``: snapshot every ``checkpoint_every`` epochs
    (atomic, asynchronous, checksummed, keep ``checkpoint_keep``);
    ``resume=True`` continues from the newest valid snapshot, as a run
    that was never interrupted.  ``on_epoch(epoch, state, record)``
    returning truthy stops the fit after that boundary's snapshot.

    ``precondition``: EigenPro (DESIGN.md §10).  ``None`` defers to
    ``cfg.precondition_k`` (0, the default, trains as before); an int is
    the rank k (0 forces it off); an ``EigenProPreconditioner`` is used as
    given.  A rank is estimated once from a Nystrom subsample of the
    training data (``precond.estimate_preconditioner``, one streamed pass,
    on ``device``), drawn from a generator derived from ``generator`` and
    ``_PRECOND_KEY_TAG``: the fit's own generator is not drawn from, so the
    epochs are those of a plain fit.  A fit on ``plans`` without a
    generator must pass a built preconditioner.  On resume the
    preconditioner is restored from the checkpoint's ``extra``.  Under
    ``schedule="const"`` with ``cfg.precondition_auto_lr`` the fit swaps
    ``lr0`` for ``pre.step_size(|J|)``.  ``FitResult.precond`` and
    ``.estimate_s`` report it."""
    if generator is None and plans is None:
        raise TypeError("fit() requires a torch.Generator (or explicit "
                        "per-epoch index plans)")
    if x_val is not None and y_val is None:
        raise TypeError(
            "fit() got x_val without y_val: validation labels are required "
            "to evaluate (pass y_val, or drop x_val to skip eval)")
    if plans is not None and len(plans) < n_epochs:
        raise ValueError(f"plans holds {len(plans)} epochs; "
                         f"n_epochs={n_epochs}")
    source = None
    if isinstance(x, DataSource):
        if y is not None:
            raise TypeError(
                "fit() over a DataSource takes the labels from the source; "
                "pass y=None")
        if isinstance(x, RingSource):
            # A live ring: fit trains a frozen, versioned snapshot of the
            # current window while the writer keeps appending (the online
            # service owns the grow-across-epochs loop).
            x = x.snapshot()
        source, x = x, None
    elif y is None:
        raise TypeError("fit() needs the labels y with arrays (or a "
                        "DataSource that holds them)")
    dev = resolve_device(device)
    hosted_data = source is not None and not isinstance(source,
                                                        InMemorySource)
    execution = trainer.resolve_execution(execution, cfg,
                                          algorithm=algorithm,
                                          hosted_data=hosted_data, mesh=mesh)
    owns_mesh = False
    if execution == "mesh" and mesh is None:
        mesh, owns_mesh = trainer.default_mesh(dev)
    try:
        return _fit(cfg, x, y, generator, source, execution, mesh, owns_mesh,
                    dev, plans=plans, algorithm=algorithm,
                    n_epochs=n_epochs, tol=tol, x_val=x_val, y_val=y_val,
                    eval_every=eval_every, verbose=verbose,
                    truncate_every=truncate_every,
                    truncate_frac=truncate_frac, eval_cache=eval_cache,
                    prefetch=prefetch, checkpoint_dir=checkpoint_dir,
                    checkpoint_every=checkpoint_every,
                    checkpoint_keep=checkpoint_keep, resume=resume,
                    callback=callback, precondition=precondition,
                    on_epoch=on_epoch)
    finally:
        if owns_mesh:
            mesh.close()        # no-op once the plan has closed it


def _fit(cfg, x, y, generator, source, execution, mesh, owns_mesh, dev, *,
         plans, algorithm, n_epochs, tol, x_val, y_val, eval_every, verbose,
         truncate_every, truncate_frac, eval_cache, prefetch, checkpoint_dir,
         checkpoint_every, checkpoint_keep, resume, callback, precondition,
         on_epoch) -> FitResult:
    """``fit`` after the execution (and, on a mesh, the mesh) is
    resolved."""
    if mesh is not None and execution in ("mesh", "bcd"):
        dev = mesh.device                   # the rank's device
        verbose = verbose and mesh.rank == 0
    else:
        mesh = None
    if execution in ("serial", "parallel"):
        algorithm = execution               # the backend IS the algorithm
        if isinstance(source, InMemorySource):
            x, y = source.x, source.y
        elif source is not None:
            raise ValueError(
                f"execution={execution!r} needs device-resident data; a "
                "HostSource trains out of core via 'hosted'")
        x, y = _f32_on(x, dev), _f32_on(y, dev)
        n = int(x.shape[0])
    else:
        if source is None:                  # arrays -> a host mirror
            source = InMemorySource(x, y)
            x = y = None
        n = source.n
    if x_val is not None:
        x_val, y_val = _f32_on(x_val, dev), _f32_on(y_val, dev)
    if eval_cache == "auto":
        eval_cache = (execution in ("serial", "parallel")
                      and x_val is not None
                      and 4 * int(x_val.shape[0]) * n
                      <= _EVAL_CACHE_BUDGET_BYTES)
    manager = None
    if checkpoint_dir is not None:
        from repro_torch.checkpoint import CheckpointManager
        manager = CheckpointManager(checkpoint_dir, keep=checkpoint_keep)
    if execution == "bcd" and truncate_every:
        raise ValueError(
            "execution='bcd' cannot truncate: zeroing alpha entries "
            "outside a round would desync the incremental residual "
            "f = K alpha that the block solves maintain")
    if execution == "bcd" and _wants_preconditioner(cfg, precondition):
        raise ValueError(
            "execution='bcd' solves each block exactly — EigenPro "
            "preconditioning applies to the stochastic step only (drop "
            "precondition/cfg.precondition_k)")
    pre, estimate_s = _resolve_preconditioner(
        cfg, precondition, source if source is not None else x, generator,
        manager=manager, resume=resume, device=dev)
    snapshot_extra = {"precond": pre.to_extra()} if pre is not None else None
    if pre is not None:
        if verbose:
            print(f"[dsekl] EigenPro: k={pre.k}, m={pre.m}, scale "
                  f"{pre.scale:.3f}, estimate {estimate_s:.3f}s")
        if cfg.precondition_auto_lr and cfg.schedule == "const":
            # The rule wants the expansion coordinates one step scatters.
            if execution == "mesh":
                j_union = mesh.size("model") * cfg.n_expand
            elif algorithm == "parallel":
                j_union = cfg.n_workers * cfg.n_expand
            else:
                j_union = cfg.n_expand
            cfg = cfg.replace(lr0=pre.step_size(j_union))
    with trainer.make_plan(execution, cfg, x=x, y=y, source=source,
                           algorithm=algorithm, prefetch=prefetch,
                           eval_cache=eval_cache, device=dev,
                           precond=pre, mesh=mesh,
                           owns_mesh=owns_mesh) as plan:
        res = trainer.fit_loop(
            plan, generator, plans=plans, n_epochs=n_epochs, tol=tol,
            x_val=x_val, y_val=y_val, eval_every=eval_every,
            verbose=verbose, truncate_every=truncate_every,
            truncate_frac=truncate_frac, callback=callback,
            manager=manager, checkpoint_every=checkpoint_every,
            resume=resume, snapshot_extra=snapshot_extra,
            on_epoch=on_epoch)
    res.precond, res.estimate_s = pre, estimate_s
    return res


def error_rate(cfg: DSEKLConfig, alpha: Tensor, x_train: Tensor, x: Tensor,
               y: Tensor) -> float:
    return float(_error(cfg, alpha, x_train, x, y))
