"""Training front door for DSEKL: ``fit`` (port of
``repro/core/solver.py``; in-memory serial fits).

The paper's stopping rule (§4.2): stop when the L2 norm of the dual
coefficients' change over one epoch is below ``tol``.  ``fit`` resolves
the execution backend (``trainer.resolve_execution``), builds the plan
(``trainer.SerialPlan``: Algorithm 1 on device-resident tensors) and drives
``trainer.fit_loop``: epoch -> truncate -> eval -> snapshot, with
checkpoint/resume through ``checkpoint.CheckpointManager``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import trainer
from repro_torch.core.dsekl import DSEKLConfig, DSEKLState
from repro_torch.core.trainer import (  # noqa: F401  (re-exported API)
    FitResult, SerialPlan, _EVAL_CACHE_BUDGET_BYTES, _error,
)
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


def _f32_on(t, device: torch.device) -> Tensor:
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.asarray(t))
    return t.to(device=device, dtype=torch.float32)


def fit(cfg: DSEKLConfig, x, y=None,
        generator: Optional[torch.Generator] = None, *,
        plans: Optional[Sequence] = None, execution: Optional[str] = None,
        n_epochs: int = 50, tol: float = 1e-3, x_val=None, y_val=None,
        eval_every: int = 1, verbose: bool = False, truncate_every: int = 0,
        truncate_frac: float = 0.1, eval_cache="auto",
        checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
        checkpoint_keep: int = 3, resume: bool = False,
        callback: Optional[Callable[[int, DSEKLState], None]] = None,
        on_epoch=None, device: DeviceLike = None) -> FitResult:
    """Run DSEKL until convergence (paper stopping rule) or ``n_epochs``.

    ``x`` (N, D) and ``y`` (N,) are tensors or arrays; they, and
    ``x_val`` / ``y_val``, are moved to ``device`` (default ``cuda``,
    which raises without a card: pass ``device="cpu"`` there).  Each epoch
    runs ``max(N // n_grad, 1)`` Alg.-1 steps on an index plan drawn from
    ``generator`` (a ``torch.Generator``; the plan is drawn on its
    device), or on ``plans[e]`` when ``plans`` is given: a sequence of
    per-epoch ``(idx_i (steps, n_grad), idx_j (steps, n_expand))``, which
    is how the tests feed both packages the JAX sampler's indices.

    ``truncate_every``: every k epochs the smallest ``truncate_frac`` of
    non-zero |alpha| mass is zeroed (paper §5's budgeted model).

    ``eval_cache``: evaluate ``x_val`` through a cached keep-all prediction
    engine (the validation kernel map is kept across epochs); ``"auto"``
    turns it on when the n_val x N map fits 1 GiB.

    ``checkpoint_dir``: snapshot every ``checkpoint_every`` epochs
    (atomic, asynchronous, checksummed, keep ``checkpoint_keep``);
    ``resume=True`` continues from the newest valid snapshot, as a run
    that was never interrupted.  ``on_epoch(epoch, state, record)``
    returning truthy stops the fit after that boundary's snapshot.

    Not ported yet, and refused: the ``parallel``, ``hosted``, ``mesh``
    and ``bcd`` executions (``NotImplementedError`` from
    ``trainer.make_plan``) and EigenPro (``cfg.precondition_k > 0``)."""
    if generator is None and plans is None:
        raise TypeError("fit() requires a torch.Generator (or explicit "
                        "per-epoch index plans)")
    if x_val is not None and y_val is None:
        raise TypeError(
            "fit() got x_val without y_val: validation labels are required "
            "to evaluate (pass y_val, or drop x_val to skip eval)")
    if y is None:
        raise TypeError("fit() needs the labels y: out-of-core data "
                        "sources are not ported yet")
    if cfg.precondition_k:
        raise NotImplementedError(
            "EigenPro preconditioning (cfg.precondition_k > 0) is not "
            "ported to repro_torch yet: ROADMAP.md section 1, item 4")
    if plans is not None and len(plans) < n_epochs:
        raise ValueError(f"plans holds {len(plans)} epochs; "
                         f"n_epochs={n_epochs}")
    dev = resolve_device(device)
    x, y = _f32_on(x, dev), _f32_on(y, dev)
    if x_val is not None:
        x_val, y_val = _f32_on(x_val, dev), _f32_on(y_val, dev)
    execution = trainer.resolve_execution(execution, cfg)
    n = int(x.shape[0])
    if eval_cache == "auto":
        eval_cache = (x_val is not None
                      and 4 * int(x_val.shape[0]) * n
                      <= _EVAL_CACHE_BUDGET_BYTES)
    manager = None
    if checkpoint_dir is not None:
        from repro_torch.checkpoint import CheckpointManager
        manager = CheckpointManager(checkpoint_dir, keep=checkpoint_keep)
    plan = trainer.make_plan(execution, cfg, x=x, y=y, eval_cache=eval_cache)
    return trainer.fit_loop(
        plan, generator, plans=plans, n_epochs=n_epochs, tol=tol,
        x_val=x_val, y_val=y_val, eval_every=eval_every, verbose=verbose,
        truncate_every=truncate_every, truncate_frac=truncate_frac,
        callback=callback, manager=manager,
        checkpoint_every=checkpoint_every, resume=resume, on_epoch=on_epoch)


def error_rate(cfg: DSEKLConfig, alpha: Tensor, x_train: Tensor, x: Tensor,
               y: Tensor) -> float:
    return float(_error(cfg, alpha, x_train, x, y))
