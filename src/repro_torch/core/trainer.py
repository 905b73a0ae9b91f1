"""The execution-backend trainer (port of ``repro/core/trainer.py``; the
in-memory serial backend).

One ``fit_loop`` drives a backend (the JAX package's ``ExecutionPlan``;
the port has one, ``SerialPlan``):

  * ``draw_plan(generator)`` — the epoch's index plan, drawn from the
    fit's ``torch.Generator`` (the JAX plans derive theirs from a key);
  * ``run_epoch(state, plan) -> state`` — execute one epoch on it;
  * ``eval_error(state, x_val, y_val)`` — the backend's validation eval.

``SerialPlan`` is Algorithm 1 on device-resident tensors: one
``dsekl.step_serial`` per row of the epoch plan, ``max(N // n_grad, 1)``
steps, no host synchronisation inside the epoch.  The JAX package's other
backends (``parallel``, ``hosted``, ``mesh``, ``bcd``) are not ported yet:
``make_plan`` raises ``NotImplementedError`` naming their ROADMAP item.

Checkpoint/resume: ``fit_loop`` snapshots ``(state, generator state,
epoch, history, converged)`` through ``checkpoint.CheckpointManager``.
The generator state stored is the one that draws the NEXT epoch's plan
(the counterpart of the JAX snapshot's pre-epoch carry key), as a uint8
array in the npz so the crc covers it: a resumed fit draws the very plans
the uninterrupted one draws.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import dsekl, sampler
from repro_torch.core.dsekl import DSEKLConfig, DSEKLState

Tensor = torch.Tensor

EXECUTIONS = ("auto", "serial", "parallel", "hosted", "mesh", "bcd")
# Executions of the JAX package the port has not reached yet, and the
# ROADMAP.md item (section 1's queue) that ports each.
NOT_PORTED = {
    "parallel": "item 2 (Algorithm 2)",
    "hosted": "item 3 (the out-of-core data plane)",
    "bcd": "item 5 (BCD)",
    "mesh": "item 6 (the mesh)",
}


@dataclasses.dataclass
class FitResult:
    state: DSEKLState
    history: List[Dict[str, Any]]
    converged: bool
    epochs_run: int
    # cache_info() of the validation engine (None without a validation
    # set or with eval_cache off).
    val_cache: Optional[Dict[str, Any]] = None
    # "converged" (the paper's stopping rule), "hook" (on_epoch asked to
    # stop) or "epochs" (the budget ran out).
    stop_reason: str = "epochs"
    # The first epoch whose |dalpha| fell below tol (None if none did) and
    # the last epoch's |dalpha|.
    epochs_to_tol: Optional[int] = None
    final_residual: float = 0.0


# ---------------------------------------------------------------------------
# Shared eval machinery.
# ---------------------------------------------------------------------------

def _sync(t: Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _truncate_smallest(alpha: Tensor, frac: float) -> Tensor:
    """Zero the smallest ``frac`` of non-zero |alpha| mass (budget step).

    Rank-based: drop exactly the k lowest-|alpha| non-zero entries, ties
    broken by position (a stable argsort).  A threshold comparison would
    zero every tied entry."""
    mag = torch.abs(alpha)
    nz = mag > 0
    k = (nz.sum().to(torch.float32) * frac).to(torch.int64)
    order = torch.argsort(torch.where(nz, mag, torch.inf), stable=True)
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=alpha.device))
    drop = nz & (ranks < k)
    return torch.where(drop, torch.zeros_like(alpha), alpha)


def _error(cfg: DSEKLConfig, alpha: Tensor, x_train: Tensor, x: Tensor,
           y: Tensor) -> Tensor:
    """Validation error rate as a 0-d tensor (f >= 0 maps to +1)."""
    f = dsekl.decision_function(cfg, alpha, x_train, x)
    return torch.mean((dsekl.predict_labels(f) != y).to(torch.float32))


# "auto" eval_cache budget: the cached validation eval materializes the
# n_val x N kernel map (4 bytes an entry); above it the eval streams.
_EVAL_CACHE_BUDGET_BYTES = 1 << 30


def _round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _make_val_engine(cfg: DSEKLConfig, x: Tensor, n_val: int):
    """Keep-all prediction engine for the validation eval: every training
    row kept (``truncate_tol=-1``, so ``update_alpha`` is legal each epoch)
    and ``cache_blocks`` sized to hold exactly the validation set's
    kernel-map tiles, so epochs after the first are cache hits."""
    from repro_torch.serving.dsekl_engine import (DSEKLPredictionEngine,
                                                  EngineConfig)

    qb = min(1024, max(64, _round_up(n_val, 64)))
    return DSEKLPredictionEngine(
        cfg, torch.zeros((x.shape[0],), dtype=torch.float32,
                         device=x.device), x,
        engine_cfg=EngineConfig(query_block=qb, truncate_tol=-1.0,
                                cache_blocks=-(-n_val // qb)),
        device=x.device)


# ---------------------------------------------------------------------------
# The serial backend.
# ---------------------------------------------------------------------------

def _indices(p, device: torch.device) -> Tensor:
    """An index plan (tensor or array) as int64 on ``device``."""
    if not isinstance(p, torch.Tensor):
        p = torch.from_numpy(np.asarray(p))
    return p.to(device=device, dtype=torch.int64)


class SerialPlan:
    """Algorithm 1 on device-resident tensors; eval through the cached
    prediction engine or the streamed error."""

    name = "serial"

    def __init__(self, cfg: DSEKLConfig, x: Tensor, y: Tensor, *,
                 eval_cache: bool = False):
        self.cfg = cfg
        self.n = int(x.shape[0])
        self.device = x.device
        self.x, self.y = x, y
        self._eval_cache = bool(eval_cache)
        self._val_engine = None

    @property
    def steps(self) -> int:
        return max(self.n // self.cfg.n_grad, 1)

    def init_state(self) -> DSEKLState:
        return dsekl.init_state(self.n, device=self.device)

    def place_state(self, flat: Dict[str, np.ndarray]) -> DSEKLState:
        """The state of a restored flat checkpoint, on this plan's device."""
        def vec(key):
            return torch.tensor(np.asarray(flat[key]), dtype=torch.float32,
                                device=self.device)

        def scalar(key):
            return torch.tensor(int(np.asarray(flat[key])),
                                dtype=torch.int32, device=self.device)

        return DSEKLState(alpha=vec("alpha"), accum=vec("accum"),
                          step=scalar("step"), epoch=scalar("epoch"))

    def draw_plan(self, generator: torch.Generator) -> Tuple[Tensor, Tensor]:
        return sampler.epoch_plan(generator, self.n, self.cfg.n_grad,
                                  self.cfg.n_expand, self.steps)

    def run_epoch(self, state: DSEKLState, plan) -> DSEKLState:
        """One epoch over ``plan = (idx_i (steps, n_grad), idx_j (steps,
        n_expand))``: tensors or arrays of indices in [0, N)."""
        idx_i, idx_j = (_indices(p, self.device) for p in plan)
        if idx_i.dim() != 2 or idx_j.dim() != 2 or (
                idx_i.shape[0] != self.steps or idx_j.shape[0] != self.steps):
            raise ValueError(
                f"an epoch plan is ({self.steps}, n_grad) and ({self.steps}, "
                f"n_expand) indices; got {tuple(idx_i.shape)} and "
                f"{tuple(idx_j.shape)}")
        state = state._replace(epoch=state.epoch + 1)
        for t in range(self.steps):
            state = dsekl.step_serial(self.cfg, state, self.x, self.y,
                                      idx_i[t], idx_j[t])
        return state

    def eval_error(self, state: DSEKLState, x_val: Tensor,
                   y_val: Tensor) -> float:
        if self._eval_cache:
            if self._val_engine is None:
                self._val_engine = _make_val_engine(self.cfg, self.x,
                                                    int(x_val.shape[0]))
            self._val_engine.update_alpha(state.alpha)
            f_val = self._val_engine.predict(x_val)
            return float(torch.mean(
                (dsekl.predict_labels(f_val) != y_val).to(torch.float32)))
        return float(_error(self.cfg, state.alpha, self.x, x_val, y_val))

    def val_cache_info(self) -> Optional[Dict[str, Any]]:
        return (self._val_engine.cache_info()
                if self._val_engine is not None else None)


# ---------------------------------------------------------------------------
# The fit loop.
# ---------------------------------------------------------------------------

def _gen_state(generator: Optional[torch.Generator]) -> np.ndarray:
    if generator is None:
        return np.zeros((0,), np.uint8)
    return generator.get_state().numpy().copy()


def _snapshot(manager, state: DSEKLState, gen_state: np.ndarray,
              epoch: int, history: List[Dict[str, Any]],
              converged: bool) -> None:
    """Checkpoint the resume closure: state, the generator state that
    draws the next epoch's plan, the epoch counter, history and the
    converged flag (a resumed fit stops where the uninterrupted one
    stopped)."""
    tree = {"alpha": state.alpha, "accum": state.accum,
            "step": state.step, "epoch": state.epoch,
            "gen_state": gen_state}
    extra = {"epoch": epoch, "history": history, "converged": converged}
    manager.save(epoch, tree, extra=extra)


def _restore(manager, plan: SerialPlan,
             generator: Optional[torch.Generator]):
    step = manager.latest_valid_step()
    if step is None:
        return None
    _, flat, extra = manager.restore(step)
    state = plan.place_state(flat)
    gen_state = np.asarray(flat.get("gen_state", np.zeros((0,), np.uint8)))
    if generator is not None and gen_state.size:
        generator.set_state(torch.from_numpy(gen_state.astype(np.uint8)))
    return (state, int(extra["epoch"]), list(extra["history"]),
            bool(extra.get("converged", False)))


def fit_loop(plan: SerialPlan, generator: Optional[torch.Generator], *,
             plans: Optional[Sequence] = None, n_epochs: int = 50,
             tol: float = 1e-3, x_val: Optional[Tensor] = None,
             y_val: Optional[Tensor] = None, eval_every: int = 1,
             verbose: bool = False, truncate_every: int = 0,
             truncate_frac: float = 0.1,
             callback: Optional[Callable[[int, DSEKLState], None]] = None,
             manager=None, checkpoint_every: int = 1, resume: bool = False,
             on_epoch: Optional[
                 Callable[[int, DSEKLState, Dict[str, Any]], Any]] = None
             ) -> FitResult:
    """Drive a ``SerialPlan`` to convergence (paper §4.2: ``|dalpha| <
    tol`` over one epoch) or ``n_epochs``: epoch -> truncate -> eval ->
    snapshot.

    Epoch e runs on ``plans[e]`` when ``plans`` is given, else on a plan
    drawn from ``generator``.  It is evaluated on the ``eval_every``
    cadence, and always on the last record of the fit (the final epoch or
    the convergence epoch).  With a ``CheckpointManager`` the loop
    snapshots every ``checkpoint_every`` epochs and at the end;
    ``resume=True`` restores the newest valid snapshot and continues as a
    run that was never interrupted.  ``on_epoch(epoch, state, record)``
    returning truthy stops the fit after that boundary's snapshot."""
    state = plan.init_state()
    history: List[Dict[str, Any]] = []
    start = 0
    converged = False
    if manager is not None and resume:
        restored = _restore(manager, plan, generator)
        if restored is not None:
            state, start, history, converged = restored
            if converged:
                # The interrupted run had met the stopping rule: an
                # uninterrupted run would have stopped here too.
                start = n_epochs
            if verbose:
                print(f"[dsekl] resumed at epoch {start} ({plan.name} "
                      "backend)" + (" — already converged" if converged
                                    else ""))
    hook_stop = False
    for e in range(start, n_epochs):
        epoch_plan = plans[e] if plans is not None else plan.draw_plan(
            generator)
        gen_state = _gen_state(generator)       # draws epoch e + 1's plan
        prev_alpha = state.alpha
        t0 = time.perf_counter()
        state = plan.run_epoch(state, epoch_plan)
        if truncate_every and (e + 1) % truncate_every == 0:
            state = state._replace(
                alpha=_truncate_smallest(state.alpha, truncate_frac))
        _sync(state.alpha)
        dt = time.perf_counter() - t0
        delta = float(torch.linalg.vector_norm(state.alpha - prev_alpha))
        converged = delta < tol
        rec: Dict[str, Any] = {"epoch": e + 1, "delta_alpha": delta,
                               "seconds": dt}
        if x_val is not None and (e % eval_every == 0 or converged
                                  or e == n_epochs - 1):
            rec["val_error"] = plan.eval_error(state, x_val, y_val)
        history.append(rec)
        if callback is not None:
            callback(e, state)
        hook_stop = bool(on_epoch(e + 1, state, rec)) \
            if on_epoch is not None else False
        if verbose:
            print(f"[dsekl] epoch {e + 1}: |dalpha|={delta:.4f} "
                  + (f"val_err={rec['val_error']:.4f}"
                     if "val_error" in rec else ""))
        if manager is not None and (
                (e + 1) % checkpoint_every == 0 or converged or hook_stop
                or e == n_epochs - 1):
            _snapshot(manager, state, gen_state, e + 1, history, converged)
        if converged or hook_stop:
            break
    if manager is not None:
        manager.wait()
    return FitResult(state=state, history=history, converged=converged,
                     epochs_run=len(history),
                     val_cache=plan.val_cache_info(),
                     stop_reason=("converged" if converged
                                  else "hook" if hook_stop else "epochs"),
                     epochs_to_tol=next(
                         (h["epoch"] for h in history
                          if h["delta_alpha"] < tol), None),
                     final_residual=(history[-1]["delta_alpha"]
                                     if history else 0.0))


def resolve_execution(execution: Optional[str], cfg: DSEKLConfig) -> str:
    """``execution=None`` defers to ``cfg.execution``; ``"auto"`` is the
    serial in-memory backend, the only one the port has."""
    execution = execution if execution is not None else cfg.execution
    if execution not in EXECUTIONS:
        raise ValueError(f"unknown execution {execution!r}; "
                         f"one of {EXECUTIONS}")
    return "serial" if execution == "auto" else execution


def make_plan(execution: str, cfg: DSEKLConfig, *, x: Tensor, y: Tensor,
              eval_cache: bool = False) -> SerialPlan:
    """The backend for a resolved ``execution``: ``SerialPlan``, or
    ``NotImplementedError`` for a backend the port has not reached."""
    if execution == "serial":
        return SerialPlan(cfg, x, y, eval_cache=eval_cache)
    if execution in NOT_PORTED:
        raise NotImplementedError(
            f"execution={execution!r} is not ported to repro_torch yet: "
            f"ROADMAP.md section 1, {NOT_PORTED[execution]}")
    raise ValueError(f"unknown execution {execution!r}")
