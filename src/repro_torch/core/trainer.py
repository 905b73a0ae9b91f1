"""The execution-backend trainer (port of ``repro/core/trainer.py``).

One ``fit_loop`` drives an ``ExecutionPlan``:

  * ``draw_plan(generator)`` — the epoch's index plan, drawn from the
    fit's ``torch.Generator`` (the JAX plans derive theirs from a key);
  * ``plan_epoch(plan)`` — queue a plan ahead of its epoch (a no-op in
    memory; the hosted backend's prefetcher starts gathering it);
  * ``run_epoch(state, plan) -> state`` — execute one epoch on it;
  * ``eval_error(state, x_val, y_val)`` — the backend's validation eval.

Five backends:

  * ``SerialPlan`` — Algorithm 1 on device-resident tensors: one
    ``dsekl.step_serial`` per row of the plan, ``max(N // n_grad, 1)``
    steps;
  * ``ParallelPlan`` — Algorithm 2 on device-resident tensors: one
    ``dsekl._parallel_inner`` per gradient batch, ``N // n_grad`` steps;
  * ``HostedPlan`` — either algorithm over a host-resident ``DataSource``
    (numpy / ``np.memmap``): the plans are replayed through ONE
    ``BlockPrefetcher`` that lives for the whole fit, the blocks it stages
    go through the block cores (the bodies of ``dsekl.grad_block`` /
    ``grad_block_parallel``, with the EigenPro correction after the
    scatter when a ``precond`` block is given), and only the
    O(N) state lives on the device.  The validation eval streams the
    source too;
  * ``BCDPlan`` — block coordinate descent rounds (``core/bcd.py``) over
    a ``DataSource``: one "epoch" is one round on a without-replacement
    block J, its two streamed passes over ``K_{.,J}`` queued one round
    ahead on ONE loader, the exact block solve in between, the residual
    ``f = K alpha`` kept on the device (and in every checkpoint); on a
    mesh, one Gram partial a data shard;
  * ``MeshPlan`` — the 2-D (data x model) mesh of ``torch.distributed``
    ranks (``launch.mesh``), one process per coordinate: per-shard source
    views (``source.split``), whole-mesh epoch plans
    (``sampler.mesh_epoch_plan``, the same on every rank, each taking its
    own rows) streamed through ONE ``MeshPrefetcher`` a rank, the step of
    ``core/distributed.py`` (an ``all_reduce`` over model of f, one over
    data of g), and a model-reduced eval.

Every backend takes an EigenPro ``precond`` (``make_plan`` stages an
``EigenProPreconditioner`` to a ``dsekl.PrecondBlock`` on the plan's
device) and hands it to each step; without one the steps run exactly what
they ran before (``BCDPlan`` refuses one).  The in-memory epochs never
synchronise the host.

The equivalence contract (``tests/test_torch_hosted.py``): on the same
plans a hosted fit equals the in-memory fit of its algorithm bit for bit
on the CPU, and on the card for Algorithm 2, whose steps scatter no
duplicate index; a mesh BCD fit equals the serial one with ``bcd_shards =
n_data`` bit for bit on the CPU.

Checkpoint/resume: ``fit_loop`` snapshots ``(state, generator state,
epoch, history, converged)`` through ``checkpoint.CheckpointManager``,
with the plan's own leaves (``ExecutionPlan.snapshot_leaves``: BCD's
residual) in the tree and the caller's ``snapshot_extra`` (the solver's
serialized preconditioner) merged into the checkpoint's ``extra``.
The generator state stored is the one that draws the NEXT epoch's plan,
taken before the loop draws that plan one epoch ahead (the counterpart of
the JAX snapshot's pre-epoch carry key), as a uint8 array in the npz so
the crc covers it: a resumed fit draws the very plans the uninterrupted
one draws.  A mesh plan checkpoints the full vectors (assembled by the
slot-stack ``all_reduce`` of ``distributed.gather_slots``), rank 0 alone
writes, and a restore re-splits them onto the current mesh: the elastic
rescale.

Spans (``repro_torch.tracing``, seen by any ``torch.profiler`` session):
``fit_loop`` marks ``repro_torch.fit.plan`` (drawing or taking a plan and
queueing it), ``.epoch`` (``run_epoch``, the truncation and the epoch's
sync), ``.delta``, ``.eval``, ``.on_epoch`` (the caller's hooks) and
``.snapshot``; each stochastic backend marks one ``repro_torch.fit.step``
a step (``dsekl``'s steps mark ``.train_pass`` and ``.update`` inside
it).  A BCD round carries ``.epoch`` alone.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch import tracing
from repro_torch.core import bcd, distributed, dsekl, sampler
from repro_torch.core.dsekl import DSEKLConfig, DSEKLState
from repro_torch.data.source import (BlockPrefetcher, MeshPrefetcher,
                                     SyncGather, SyncMeshGather)

Tensor = torch.Tensor

EXECUTIONS = ("auto", "serial", "parallel", "hosted", "mesh", "bcd")
# The seed of the compressed mesh reduction's uniforms at global step t is
# _COMPRESS_SEED + t: the same on every rank (JAX folds one key on every
# device), and replayed by a resumed fit.
_COMPRESS_SEED = 0x5EED


@dataclasses.dataclass
class FitResult:
    state: DSEKLState
    history: List[Dict[str, Any]]
    converged: bool
    epochs_run: int
    # cache_info() of the validation engine (None without a validation
    # set or with eval_cache off).
    val_cache: Optional[Dict[str, Any]] = None
    # The loader's counters of a hosted fit over all its epochs (steps,
    # gather_s, wait_s); None in memory.
    loader: Optional[Dict[str, float]] = None
    # "converged" (the paper's stopping rule), "hook" (on_epoch asked to
    # stop) or "epochs" (the budget ran out).
    stop_reason: str = "epochs"
    # The first epoch whose |dalpha| fell below tol (None if none did) and
    # the last epoch's |dalpha|.
    epochs_to_tol: Optional[int] = None
    final_residual: float = 0.0
    # The fit's EigenPro preconditioner (None without one) and the
    # seconds its estimate took (0.0 when it was given or restored).
    precond: Optional[Any] = None
    estimate_s: float = 0.0


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


def _error_source(cfg: DSEKLConfig, alpha: Tensor, source, x: Tensor,
                  y: Tensor) -> float:
    """Validation error with the train set streamed from a host source."""
    f = dsekl.decision_function_source(cfg, alpha, source, x)
    return float(torch.mean((dsekl.predict_labels(f) != y).to(torch.float32)))


def _apply_then_gather(cfg: DSEKLConfig, state: DSEKLState, idx_j: Tensor,
                       g: Tensor, idx_next: Tensor,
                       idx_p: Optional[Tensor] = None,
                       delta: Optional[Tensor] = None
                       ) -> Tuple[DSEKLState, Tensor]:
    """Step t's scatter (and, with ``idx_p`` / ``delta``, the EigenPro
    correction's after it), then step t+1's alpha gather: the only
    N-shaped operations of a hosted step.  Alg. 1's and Alg. 2's scatters
    are one function (``dsekl.apply_update_parallel`` is
    ``apply_update`` over the J union)."""
    state = dsekl.apply_update(cfg, state, idx_j, g)
    if delta is not None:
        state = dsekl._apply_correction(cfg, state, idx_p, delta)
    return state, state.alpha[idx_next]


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
# The ExecutionPlan interface.
# ---------------------------------------------------------------------------

def _indices(p, device: torch.device) -> Tensor:
    """An index plan (tensor or array) as int64 on ``device``."""
    if not isinstance(p, torch.Tensor):
        p = torch.from_numpy(np.asarray(p))
    return p.to(device=device, dtype=torch.int64)


def _host_indices(p) -> np.ndarray:
    """An index plan (tensor or array) as an int64 numpy array."""
    if isinstance(p, torch.Tensor):
        p = p.cpu().numpy()
    return np.asarray(p, dtype=np.int64)


def _check_plan(name: str, plan, steps: int, ndims: Sequence[int]) -> None:
    """A ``name`` epoch plan is index arrays of ``steps`` rows with
    ``ndims`` dimensions (2 for I and Alg.-1's J, 3 for Alg.-2's J)."""
    got = [tuple(p.shape) for p in plan]
    if len(got) != len(ndims) or any(
            len(g) != nd or g[0] != steps for g, nd in zip(got, ndims)):
        raise ValueError(f"a {name} epoch plan is {len(ndims)} index "
                         f"arrays of {steps} steps with {list(ndims)} "
                         f"dimensions; got shapes {got}")


class ExecutionPlan:
    """One training backend: how epochs execute and where the data lives.
    ``fit_loop`` is backend-agnostic; everything placement-specific lives
    behind this interface.  ``algorithm`` ("serial": Algorithm 1,
    "parallel": Algorithm 2) sets the steps and the plans of an epoch."""

    name = "base"
    algorithm = "serial"

    def __init__(self, cfg: DSEKLConfig, n: int, device: torch.device,
                 precond: Optional[dsekl.PrecondBlock] = None):
        self.cfg = cfg
        self.n = int(n)
        self.device = device
        self.precond = precond

    # -- state ----------------------------------------------------------
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

    def snapshot_leaves(self, state: DSEKLState) -> Dict[str, Any]:
        """Backend-owned leaves that ride in every checkpoint's tree
        beside the state (none by default)."""
        return {}

    # -- what a mesh plan does across its ranks (identities here) -------
    # Whether this process prints and writes checkpoints (rank 0).
    is_lead = True

    def snapshot_state(self, state: DSEKLState) -> DSEKLState:
        """The state a checkpoint stores: the full vectors."""
        return state

    def delta_norm(self, new: Tensor, old: Tensor) -> float:
        """|new - old| of alpha over the whole model (the stopping rule)."""
        return float(torch.linalg.vector_norm(new - old))

    def truncate(self, state: DSEKLState, frac: float) -> DSEKLState:
        """The budget step over the whole model."""
        return state._replace(alpha=_truncate_smallest(state.alpha, frac))

    def barrier(self) -> None:
        """Wait for every rank (after the last checkpoint is written)."""

    # -- epochs ---------------------------------------------------------
    @property
    def steps(self) -> int:
        """Steps an epoch: Alg. 1 takes ``max(N // n_grad, 1)``, Alg. 2 one
        a gradient batch, ``N // n_grad`` (none when N < n_grad)."""
        if self.algorithm == "serial":
            return max(self.n // self.cfg.n_grad, 1)
        return self.n // self.cfg.n_grad

    def draw_plan(self, generator: torch.Generator) -> Tuple[Tensor, Tensor]:
        """An epoch's index plan from ``generator``, on its device."""
        cfg = self.cfg
        if self.algorithm == "serial":
            return sampler.epoch_plan(generator, self.n, cfg.n_grad,
                                      cfg.n_expand, self.steps)
        return sampler.parallel_epoch_plan(generator, self.n, cfg.n_grad,
                                           cfg.n_expand, cfg.n_workers)

    def check_plan(self, plan) -> None:
        """Refuse a plan whose shapes are not an epoch of this backend:
        (steps, n_grad) indices of I with (steps, n_expand) of J for
        Alg. 1, or (steps, K, n_expand) for Alg. 2."""
        _check_plan(f"{self.name} ({self.algorithm})", plan, self.steps,
                    (2, 2 if self.algorithm == "serial" else 3))

    def plan_epoch(self, plan) -> None:
        """Queue ``plan`` ahead of its epoch (no-op in memory)."""

    def run_epoch(self, state: DSEKLState, plan) -> DSEKLState:
        raise NotImplementedError

    # -- eval / reporting -----------------------------------------------
    def eval_error(self, state: DSEKLState, x_val: Tensor,
                   y_val: Tensor) -> float:
        raise NotImplementedError

    def val_cache_info(self) -> Optional[Dict[str, Any]]:
        return None

    def loader_stats(self) -> Optional[Dict[str, float]]:
        return None

    def close(self) -> None:
        pass

    def __enter__(self) -> "ExecutionPlan":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _InMemoryPlan(ExecutionPlan):
    """The device-resident backends' shared base: x and y on the device,
    eval through the cached prediction engine or the streamed error."""

    def __init__(self, cfg: DSEKLConfig, x: Tensor, y: Tensor, *,
                 eval_cache: bool = False,
                 precond: Optional[dsekl.PrecondBlock] = None):
        super().__init__(cfg, int(x.shape[0]), x.device, precond)
        self.x, self.y = x, y
        self._eval_cache = bool(eval_cache)
        self._val_engine = None

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


class SerialPlan(_InMemoryPlan):
    """Algorithm 1 on device-resident tensors."""

    name = "serial"

    def run_epoch(self, state: DSEKLState, plan) -> DSEKLState:
        """One epoch over ``plan = (idx_i (steps, n_grad), idx_j (steps,
        n_expand))``: tensors or arrays of indices in [0, N)."""
        self.check_plan(plan)
        idx_i, idx_j = (_indices(p, self.device) for p in plan)
        state = state._replace(epoch=state.epoch + 1)
        for t in range(self.steps):
            with tracing.span("repro_torch.fit.step"):
                state = dsekl.step_serial(self.cfg, state, self.x, self.y,
                                          idx_i[t], idx_j[t], self.precond)
        return state


class ParallelPlan(_InMemoryPlan):
    """Algorithm 2 on device-resident tensors."""

    name = "parallel"
    algorithm = "parallel"

    def run_epoch(self, state: DSEKLState, plan) -> DSEKLState:
        """One epoch over ``plan = (i_batches (steps, n_grad), idx_jk
        (steps, K, n_expand))``; with N < n_grad it has no step and the
        state comes back with only its epoch counted."""
        self.check_plan(plan)
        i_batches, idx_jk = (_indices(p, self.device) for p in plan)
        return dsekl.epoch_parallel(self.cfg, state, self.x, self.y,
                                    i_batches, idx_jk, self.precond)


class HostedPlan(ExecutionPlan):
    """Either algorithm over a host-resident ``DataSource``.

    Epoch plans are queued onto ONE loader (a ``BlockPrefetcher``, or
    ``SyncGather`` with ``prefetch=False``) that lives for the whole fit:
    ``plan_epoch`` extends its plan, so when the driver plans epoch e + 1
    before running epoch e the worker streams straight across the
    boundary.  A step takes the staged blocks, runs the block core
    (``dsekl.grad_block`` / ``grad_block_parallel``, with the EigenPro
    correction when a ``precond`` block is given) and
    ``_apply_then_gather``.  Only alpha, accum, the staged blocks and the
    preconditioner live on the device."""

    name = "hosted"

    def __init__(self, cfg: DSEKLConfig, source, *,
                 algorithm: str = "serial", prefetch: bool = True,
                 device: torch.device,
                 precond: Optional[dsekl.PrecondBlock] = None):
        super().__init__(cfg, source.n, device, precond)
        if algorithm not in ("serial", "parallel"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        self.source = source
        self.algorithm = algorithm
        self.prefetch = prefetch
        self._loader = None
        # Queued epochs, FIFO: (the plan as given, its host index arrays).
        self._queued: collections.deque = collections.deque()
        self._consumed_steps = 0

    def plan_epoch(self, plan) -> None:
        self.check_plan(plan)
        plan_i, plan_j = (_host_indices(p) for p in plan)
        # An explicit flat width: reshape(0, -1) is ambiguous for the
        # empty plan (N < n_grad on the parallel path).
        flat_j = plan_j.reshape(plan_i.shape[0],
                                int(np.prod(plan_j.shape[1:], dtype=int)))
        if self._loader is None:
            if self.prefetch:
                self._loader = BlockPrefetcher(self.source, plan_i, flat_j,
                                               device=self.device)
            else:
                self._loader = SyncGather(self.source, plan_i, flat_j,
                                          device=self.device)
        else:
            self._loader.extend(plan_i, flat_j)
        self._queued.append((plan, plan_i, plan_j))

    def _pop_plan(self, plan):
        if not self._queued:
            self.plan_epoch(plan)
        elif self._queued[0][0] is not plan:
            raise RuntimeError(
                "hosted epochs must be consumed in the order they were "
                "planned (the prefetcher streams one plan)")
        return self._queued.popleft()

    def run_epoch(self, state: DSEKLState, plan) -> DSEKLState:
        _, plan_i, plan_j = self._pop_plan(plan)
        state = state._replace(epoch=state.epoch + 1)
        steps = plan_i.shape[0]
        if steps == 0:
            # N < n_grad on the parallel path: no step, as in memory.
            return state
        cfg, loader, pc = self.cfg, self._loader, self.precond
        n_eff = dsekl.scale_n(cfg, self.n)
        # The epoch's J indices stay on the host (pinned on the card): each
        # step copies the next step's row of them ahead, asynchronously, so
        # no epoch-sized index plan lives on the device.
        idx_host = torch.from_numpy(plan_j.reshape(steps, -1))
        if self.device.type == "cuda":
            idx_host = idx_host.pin_memory()

        def idx_j(t):
            return idx_host[t].to(self.device, non_blocking=True)

        serial = self.algorithm == "serial"
        j_union = cfg.n_expand if serial else cfg.n_workers * cfg.n_expand
        idx_p = None if pc is None else pc.indices
        idx_cur = idx_j(0)
        aj = state.alpha[idx_cur]
        for t in range(steps):
            with tracing.span("repro_torch.fit.step"):
                xi, yi, xj = loader.get()
                if serial:
                    f, g = dsekl._grad_block_with_f(cfg, xi, yi, xj, aj,
                                                    n_eff)
                else:
                    k, j = plan_j.shape[1:]
                    f, g = dsekl._grad_block_parallel_with_f(
                        cfg, xi, yi, xj.reshape(k, j, xj.shape[-1]),
                        aj.reshape(k, j), n_eff)
                delta = (None if pc is None
                         else dsekl._delta(cfg, xi, yi, f, pc, j_union))
                idx_next = idx_j(t + 1) if t + 1 < steps else idx_cur
                state, aj = _apply_then_gather(cfg, state, idx_cur, g,
                                               idx_next, idx_p, delta)
                idx_cur = idx_next
        self._consumed_steps += steps
        return state

    def eval_error(self, state: DSEKLState, x_val: Tensor,
                   y_val: Tensor) -> float:
        # The eval streams the source too: the dataset never becomes
        # device-resident.
        return _error_source(self.cfg, state.alpha, self.source, x_val,
                             y_val)

    def loader_stats(self) -> Optional[Dict[str, float]]:
        if self._loader is None:
            return None
        st = dict(self._loader.stats())
        # Steps CONSUMED, not planned: the driver plans one epoch ahead,
        # so a fit that stops early leaves a planned epoch unrun.
        st["steps"] = self._consumed_steps
        return st

    def close(self) -> None:
        if self._loader is not None:
            self._loader.close()
            self._loader = None
        self._queued.clear()


class _MeshRanks:
    """What the mesh backends share across their ranks: one global
    stopping rule, checkpoints of the full vectors written by rank 0, the
    model-reduced eval, and the world of one torn down on ``close()`` when
    the plan built it.  A plan with no mesh (``self.mesh`` None: a serial
    ``BCDPlan``) keeps ``ExecutionPlan``'s single-process behaviour."""

    mesh = None

    def _init_mesh(self, mesh, source, owns_mesh: bool) -> None:
        self.mesh = mesh
        self._owns_mesh = bool(owns_mesh)
        self.n_data = mesh.size(distributed.DATA)
        self.n_model = mesh.size(distributed.MODEL)
        self.coord = (mesh.index(distributed.DATA),
                      mesh.index(distributed.MODEL))
        self.data_sources = source.split(self.n_data)
        self.model_sources = source.split(self.n_model)
        self._rows_m = self.n // self.n_model
        self._eval = None

    @property
    def is_lead(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _check_n(self, flat: Dict[str, np.ndarray], what: str) -> None:
        n_ckpt = int(np.asarray(flat["alpha"]).shape[0])
        if n_ckpt != self.n:
            # The elastic rescale re-places the SAME N onto another mesh
            # shape; another N means the data (or its trim) changed.
            raise ValueError(
                f"checkpoint carries alpha of {n_ckpt} rows but this {what} "
                f"fit trains {self.n}; an elastic rescale must keep the "
                "(trimmed) row count identical across mesh shapes — pick "
                "N divisible by every data/model axis size you resume on")

    def _place_shards(self, flat: Dict[str, np.ndarray]) -> DSEKLState:
        full = ExecutionPlan.place_state(self, flat)
        return full._replace(
            alpha=distributed.state_shard(self.mesh, full.alpha).clone(),
            accum=distributed.state_shard(self.mesh, full.accum).clone())

    def snapshot_state(self, state: DSEKLState) -> DSEKLState:
        if self.mesh is None:
            return state
        g = distributed.gather_model_shards
        return state._replace(alpha=g(self.mesh, state.alpha),
                              accum=g(self.mesh, state.accum))

    def delta_norm(self, new: Tensor, old: Tensor) -> float:
        if self.mesh is None:
            return ExecutionPlan.delta_norm(self, new, old)
        # The norm of the full vectors, as one process takes it; rank 0's
        # reading goes to every rank, so all stop at the same epoch.
        g = distributed.gather_model_shards
        norm = torch.linalg.vector_norm(g(self.mesh, new)
                                        - g(self.mesh, old)).reshape(1)
        tdist.broadcast(norm, src=0)
        return float(norm[0])

    def truncate(self, state: DSEKLState, frac: float) -> DSEKLState:
        if self.mesh is None:
            return ExecutionPlan.truncate(self, state, frac)
        full = distributed.gather_model_shards(self.mesh, state.alpha)
        return state._replace(alpha=distributed.state_shard(
            self.mesh, _truncate_smallest(full, frac)).clone())

    def barrier(self) -> None:
        if self.mesh is not None:
            tdist.barrier()

    def eval_error(self, state: DSEKLState, x_val: Tensor,
                   y_val: Tensor) -> float:
        if self._eval is None:
            self._eval = distributed.make_mesh_eval(self.cfg, self.mesh)
        f = self._eval(state.alpha, self.model_sources, x_val)
        return float(torch.mean(
            (dsekl.predict_labels(f) != y_val).to(torch.float32)))

    def _close_mesh(self) -> None:
        if self.mesh is not None and self._owns_mesh:
            self.mesh.close()
            self._owns_mesh = False


class MeshPlan(_MeshRanks, ExecutionPlan):
    """The 2-D (data x model) mesh, one rank a coordinate, driven end to
    end.

    Each rank gathers its data shard's rows from its ``data_sources[d]``
    view and its model shard's from ``model_sources[m]``
    (``source.split``).  ``draw_plan`` draws the whole mesh's epoch plan
    (``sampler.mesh_epoch_plan``: LOCAL indices, I per data shard and J
    per model shard); every rank draws it from the same generator state,
    so no plan is broadcast, and ``plan_epoch`` queues it onto the rank's
    ONE ``MeshPrefetcher`` (``SyncMeshGather`` with ``prefetch=False``),
    which stages the rank's blocks on its device while it runs the
    previous step.  A step is ``distributed.make_distributed_block_step``'s
    (with the replicated EigenPro block when ``precond`` is given).  On the
    device live only the alpha / accum shard and the sampled blocks; the
    eval streams the rank's model shard and reduces over model.

    An epoch is ``max(N // (n_grad * n_data), 1)`` steps: every step
    consumes ``n_data * n_grad`` gradient rows.  The epoch ends with a
    sync, as JAX's does."""

    name = "mesh"

    def __init__(self, cfg: DSEKLConfig, source, mesh, *,
                 prefetch: bool = True,
                 precond: Optional[dsekl.PrecondBlock] = None,
                 owns_mesh: bool = False):
        ExecutionPlan.__init__(self, cfg, source.n, mesh.device, precond)
        self._init_mesh(mesh, source, owns_mesh)
        self.prefetch = bool(prefetch)
        self.step_fn = distributed.make_distributed_block_step(
            cfg, mesh, self.n, precondition=precond is not None)
        self._gen = (torch.Generator(device=self.device)
                     if cfg.compress_bits else None)
        self._t = 0                     # the global step, on the host
        self._loader = None
        # Queued epoch plans, FIFO, as given.
        self._queued: collections.deque = collections.deque()
        self._consumed_steps = 0

    # -- state ----------------------------------------------------------
    def init_state(self) -> DSEKLState:
        sh = distributed.init_sharded_state(self.mesh, self.n)
        self._t = 0
        return DSEKLState(alpha=sh.alpha, accum=sh.accum, step=sh.step,
                          epoch=torch.zeros((), dtype=torch.int32,
                                            device=self.device))

    def place_state(self, flat: Dict[str, np.ndarray]) -> DSEKLState:
        self._check_n(flat, "mesh")
        self._t = int(np.asarray(flat["step"]))
        return self._place_shards(flat)

    # -- planning -------------------------------------------------------
    @property
    def steps(self) -> int:
        return max(self.n // (self.cfg.n_grad * self.n_data), 1)

    def draw_plan(self, generator: torch.Generator) -> Tuple[Tensor, Tensor]:
        cfg = self.cfg
        return sampler.mesh_epoch_plan(
            generator, cfg.n_grad, cfg.n_expand,
            tuple(s.n for s in self.data_sources),
            tuple(s.n for s in self.model_sources), self.steps)

    def check_plan(self, plan) -> None:
        """A mesh epoch plan is ``(idx_i (steps, n_data, n_grad), idx_j
        (steps, n_model, n_expand))`` of LOCAL indices."""
        want = [(self.steps, self.n_data, self.cfg.n_grad),
                (self.steps, self.n_model, self.cfg.n_expand)]
        got = [tuple(p.shape) for p in plan]
        if got != want:
            raise ValueError(f"a mesh epoch plan is two index arrays of "
                             f"shapes {want}; got {got}")

    def plan_epoch(self, plan) -> None:
        self.check_plan(plan)
        plan_i, plan_j = (_host_indices(p) for p in plan)
        if self._loader is None:
            if self.prefetch:
                self._loader = MeshPrefetcher(
                    self.data_sources, self.model_sources, plan_i, plan_j,
                    coord=self.coord, device=self.device)
            else:
                self._loader = SyncMeshGather(
                    self.data_sources, self.model_sources, plan_i, plan_j,
                    coord=self.coord, device=self.device)
        else:
            self._loader.extend(plan_i, plan_j)
        self._queued.append(plan)

    def _pop_plan(self, plan):
        if not self._queued:
            self.plan_epoch(plan)
        elif self._queued[0] is not plan:
            raise RuntimeError(
                "mesh epochs must be consumed in the order they were "
                "planned (the prefetcher streams one plan)")
        return self._queued.popleft()

    def _generator(self) -> Optional[torch.Generator]:
        """The compressed reduction's generator, seeded for this step."""
        if self._gen is None:
            return None
        self._gen.manual_seed(_COMPRESS_SEED + self._t)
        return self._gen

    # -- epochs ---------------------------------------------------------
    def run_epoch(self, state: DSEKLState, plan) -> DSEKLState:
        self._pop_plan(plan)
        sh = distributed.ShardedDSEKLState(state.alpha, state.accum,
                                          state.step)
        pc, loader = self.precond, self._loader
        for _ in range(self.steps):
            with tracing.span("repro_torch.fit.step"):
                xi, yi, xj, idx_j = loader.get()
                gen = self._generator()
                if pc is None:
                    sh = self.step_fn(xi, yi, xj, idx_j, sh, generator=gen)
                else:
                    sh = self.step_fn(xi, yi, xj, idx_j, sh, pc,
                                      generator=gen)
                self._t += 1
        _sync(sh.alpha)                         # epoch-boundary sync
        self._consumed_steps += self.steps
        return DSEKLState(alpha=sh.alpha, accum=sh.accum, step=sh.step,
                          epoch=state.epoch + 1)

    def loader_stats(self) -> Optional[Dict[str, float]]:
        if self._loader is None:
            return None
        st = dict(self._loader.stats())
        # Steps CONSUMED, not planned (the driver plans one epoch ahead).
        st["steps"] = self._consumed_steps
        return st

    def close(self) -> None:
        if self._loader is not None:
            self._loader.close()
            self._loader = None
        self._queued.clear()
        self._close_mesh()


class BCDPlan(_MeshRanks, ExecutionPlan):
    """Block coordinate descent rounds (``core/bcd.py``; DESIGN.md §14).

    One "epoch" of the fit loop is one round: the plan is the round's
    without-replacement coordinate block J, a ``(|J|,)`` index array
    (``draw_plan`` draws it with ``bcd.sample_block``).  ``K_{.,J}``
    streams row block by row block through ONE loader for the whole fit
    (a ``BlockPrefetcher``, or ``SyncGather`` with ``prefetch=False``):
    ``plan_epoch`` queues the round's two passes, so with the fit loop
    planning one round ahead the worker streams across rounds.  Pass 1
    accumulates the augmented Gram/rhs of each of ``cfg.bcd_shards`` row
    groups; the partials go to the host and are summed there in fixed
    order; the |J| x |J| system is solved exactly (Cholesky, jitter
    ladder), alpha_J += d, and pass 2 updates the residual ``f = K
    alpha`` by ``K_{.,J} d`` on the device.  Square loss only: BCD solves
    the regularized least-squares dual, and there is no hinge variant of
    the exact block solve.  The residual rides in every checkpoint
    (``snapshot_leaves``), so a resumed fit equals the uninterrupted one
    bit for bit.  The validation eval streams the source
    (``dsekl.decision_function_source``: the matvec).

    On a mesh (``mesh=``) each data shard is one row group: rank (d, m)
    streams its shard's tiles against x_J gathered from the whole source,
    keeps its shard's residual, and its Gram partial comes home through
    the slot stack (``bcd.make_mesh_bcd_ops``); the fixed-order sum runs on
    the host and the solve is replicated on every rank, each of which
    scatters the entries of J its alpha shard owns.  The contract: a mesh
    fit equals the serial one with ``bcd_shards = n_data`` bit for bit on
    the CPU."""

    name = "bcd"

    def __init__(self, cfg: DSEKLConfig, source, *, prefetch: bool = True,
                 device: Optional[torch.device] = None, mesh=None,
                 owns_mesh: bool = False):
        ExecutionPlan.__init__(self, cfg, source.n,
                               mesh.device if mesh is not None else device)
        device = self.device
        self.mesh = mesh
        self._owns_mesh = False
        if cfg.loss != "square":
            raise ValueError(
                "execution='bcd' solves the regularized square-loss "
                f"system; cfg.loss={cfg.loss!r} has no exact block solve "
                "(set loss='square')")
        self.source = source
        self.prefetch = bool(prefetch)
        self.j_size = bcd.block_size(cfg, self.n)
        self.rb = bcd.row_block_size(cfg)
        self._lam_n = float(cfg.lam * self.n)
        if mesh is not None:
            self._init_mesh(mesh, source, owns_mesh)
            if cfg.bcd_shards and cfg.bcd_shards != self.n_data:
                raise ValueError(
                    f"cfg.bcd_shards={cfg.bcd_shards} conflicts with the "
                    f"mesh's data axis of {self.n_data} shards (on a mesh "
                    "the Gram partials are one-per-data-device; leave "
                    "bcd_shards=0 or match it)")
            self.shards = self.n_data
            self._ops = bcd.make_mesh_bcd_ops(mesh)
        else:
            self.shards = int(cfg.bcd_shards or 1)
        idx_np, mask_np = bcd.row_plan(self.n, self.shards, self.rb)
        self._idx_np = idx_np
        self.blocks_per_group = idx_np.shape[1]
        # Round-invariant: each tile's rows and mask, indexed per tile (on
        # a mesh the data shard's LOCAL rows, the same for every shard).
        self._idx_dev = torch.from_numpy(
            idx_np[0] if mesh is not None else idx_np).to(device)
        self._mask_dev = torch.from_numpy(mask_np).to(device)
        self._f: Optional[Tensor] = None
        self._loader = None
        # Queued rounds, FIFO: (the plan as given, J as host indices).
        self._queued: collections.deque = collections.deque()
        self._consumed_steps = 0

    # -- state ----------------------------------------------------------
    def init_state(self) -> DSEKLState:
        rows = self.n if self.mesh is None else self.n // self.n_data
        self._f = torch.zeros((rows,), dtype=torch.float32,
                              device=self.device)
        state = ExecutionPlan.init_state(self)
        if self.mesh is None:
            return state
        sh = distributed.init_sharded_state(self.mesh, self.n)
        return state._replace(alpha=sh.alpha, accum=sh.accum)

    def place_state(self, flat: Dict[str, np.ndarray]) -> DSEKLState:
        if "bcd_f" not in flat:
            raise ValueError(
                "checkpoint carries no 'bcd_f' residual leaf — it was "
                "written by a non-BCD fit; a BCD resume needs the "
                "incremental f = K alpha to continue bit-identically")
        if self.mesh is not None:
            self._check_n(flat, "mesh BCD")
            rows = self.n // self.n_data
            d = self.coord[0]
            self._f = torch.tensor(
                np.asarray(flat["bcd_f"])[d * rows:(d + 1) * rows],
                dtype=torch.float32, device=self.device)
            return self._place_shards(flat)
        n_ckpt = int(np.asarray(flat["alpha"]).shape[0])
        if n_ckpt != self.n:
            raise ValueError(
                f"checkpoint carries alpha of {n_ckpt} rows but this BCD "
                f"fit trains {self.n}; the (trimmed) row count must stay "
                "identical across resumes")
        self._f = torch.tensor(np.asarray(flat["bcd_f"]),
                               dtype=torch.float32, device=self.device)
        return ExecutionPlan.place_state(self, flat)

    def snapshot_leaves(self, state: DSEKLState) -> Dict[str, Any]:
        if self.mesh is not None:           # every data shard's residual
            return {"bcd_f": distributed.gather_slots(
                self.mesh, self._f, distributed.DATA).reshape(-1)}
        return {"bcd_f": self._f}

    # -- planning -------------------------------------------------------
    def draw_plan(self, generator: torch.Generator) -> np.ndarray:
        return bcd.sample_block(generator, self.n, self.j_size)

    def check_plan(self, plan) -> None:
        """A round's plan is J: one index array of shape (|J|,)."""
        shape = tuple(plan.shape)
        if shape != (self.j_size,):
            raise ValueError(f"a bcd round plan is J, one index array of "
                             f"shape ({self.j_size},); got {shape}")

    def plan_epoch(self, plan) -> None:
        self.check_plan(plan)
        j_idx = _host_indices(plan)
        if self.mesh is not None:
            self._plan_round_mesh(j_idx)
            self._queued.append((plan, j_idx))
            return
        pass1 = self._idx_np.reshape(self.shards * self.blocks_per_group,
                                     self.rb)
        plan_i = np.concatenate([pass1, pass1])           # two passes
        plan_j = np.ascontiguousarray(np.broadcast_to(
            j_idx, (plan_i.shape[0], self.j_size)))
        if self._loader is None:
            cls = BlockPrefetcher if self.prefetch else SyncGather
            self._loader = cls(self.source, plan_i, plan_j,
                               device=self.device)
        else:
            self._loader.extend(plan_i, plan_j)
        self._queued.append((plan, j_idx))

    def _pop_plan(self, plan):
        if not self._queued:
            self.plan_epoch(plan)
        elif self._queued[0][0] is not plan:
            raise RuntimeError(
                "bcd rounds must be consumed in the order they were "
                "planned (the prefetcher streams one plan)")
        return self._queued.popleft()

    def _plan_round_mesh(self, j_idx: np.ndarray) -> None:
        """Queue a mesh round's two passes: every data shard's local tiles
        (one mesh plan whose single "model shard" is the whole source, J
        GLOBAL), this rank taking its own shard's."""
        blocks = self.blocks_per_group
        local = self._idx_np[0]                  # (blocks, rb), shard-local
        plan_i = np.ascontiguousarray(np.broadcast_to(
            local[:, None, :], (blocks, self.n_data, self.rb)))
        plan_i = np.concatenate([plan_i, plan_i])        # two passes
        plan_j = np.ascontiguousarray(np.broadcast_to(
            j_idx, (2 * blocks, 1, self.j_size)))
        if self._loader is None:
            cls = MeshPrefetcher if self.prefetch else SyncMeshGather
            self._loader = cls(self.data_sources, [self.source], plan_i,
                               plan_j, coord=(self.coord[0], 0),
                               device=self.device)
        else:
            self._loader.extend(plan_i, plan_j)

    # -- rounds ---------------------------------------------------------
    def run_epoch(self, state: DSEKLState, plan) -> DSEKLState:
        _, j_idx = self._pop_plan(plan)
        if self.mesh is not None:
            return self._run_round_mesh(state)
        cfg, j, loader = self.cfg, self.j_size, self._loader
        blocks, f = self.blocks_per_group, self._f
        parts = np.empty((self.shards, j, j + 1), np.float32)
        xj_dev = None
        for d in range(self.shards):
            gb = torch.zeros((j, j + 1), dtype=torch.float32,
                             device=self.device)
            for t in range(blocks):
                xi, yi, xj = loader.get()
                if xj_dev is None:
                    xj_dev = xj
                gb = bcd.acc_serial(cfg, xi, yi, xj, f, self._idx_dev[d, t],
                                    self._mask_dev[t], gb)
            parts[d] = gb.cpu().numpy()        # the partial to the host
        g_h, b_h = bcd.split_gram(bcd.combine_partials(parts))
        idx_j = torch.from_numpy(j_idx).to(self.device)
        rhs = b_h - np.float32(self._lam_n) * f[idx_j].cpu().numpy()
        delta, _ = bcd.solve_block(cfg, xj_dev, g_h, rhs, self._lam_n)
        alpha = bcd.scatter_alpha(state.alpha, idx_j, delta)
        for d in range(self.shards):
            for t in range(blocks):
                xi, _, _ = loader.get()
                f = bcd.fupd_serial(cfg, xi, xj_dev, delta, f,
                                    self._idx_dev[d, t], self._mask_dev[t])
        _sync(f)
        self._f = f
        self._consumed_steps += 2 * self.shards * blocks
        return state._replace(alpha=alpha, step=state.step + 1,
                              epoch=state.epoch + 1)

    def _run_round_mesh(self, state: DSEKLState) -> DSEKLState:
        cfg, ops, loader = self.cfg, self._ops, self._loader
        j, blocks, f = self.j_size, self.blocks_per_group, self._f
        gb = torch.zeros((j, j + 1), dtype=torch.float32, device=self.device)
        xj_dev = idxj_dev = None
        for t in range(blocks):
            xi, yi, xj, idx_j = loader.get()
            xj_dev, idxj_dev = xj, idx_j
            gb = bcd.acc_serial(cfg, xi, yi, xj, f, self._idx_dev[t],
                                self._mask_dev[t], gb)
        g_h, b_h = bcd.split_gram(bcd.combine_partials(ops.partials(gb)))
        rhs = b_h - np.float32(self._lam_n) * ops.f_at(f, idxj_dev)
        delta, _ = bcd.solve_block(cfg, xj_dev, g_h, rhs, self._lam_n)
        alpha = ops.scatter(state.alpha, idxj_dev, delta)
        for t in range(blocks):
            xi, _, _, _ = loader.get()
            f = bcd.fupd_serial(cfg, xi, xj_dev, delta, f,
                                self._idx_dev[t], self._mask_dev[t])
        _sync(f)
        self._f = f
        self._consumed_steps += 2 * blocks
        return state._replace(alpha=alpha, step=state.step + 1,
                              epoch=state.epoch + 1)

    # -- eval / reporting -----------------------------------------------
    def eval_error(self, state: DSEKLState, x_val: Tensor,
                   y_val: Tensor) -> float:
        if self.mesh is not None:
            return _MeshRanks.eval_error(self, state, x_val, y_val)
        return _error_source(self.cfg, state.alpha, self.source, x_val,
                             y_val)

    def loader_stats(self) -> Optional[Dict[str, float]]:
        if self._loader is None:
            return None
        st = dict(self._loader.stats())
        # Tiles CONSUMED (two passes a round), not planned.
        st["steps"] = self._consumed_steps
        return st

    def close(self) -> None:
        if self._loader is not None:
            self._loader.close()
            self._loader = None
        self._queued.clear()
        self._close_mesh()


# ---------------------------------------------------------------------------
# The fit loop.
# ---------------------------------------------------------------------------

def _gen_state(generator: Optional[torch.Generator]) -> np.ndarray:
    if generator is None:
        return np.zeros((0,), np.uint8)
    return generator.get_state().numpy().copy()


def _snapshot(manager, state: DSEKLState, gen_state: np.ndarray,
              epoch: int, history: List[Dict[str, Any]], converged: bool,
              extra_fields: Optional[Dict[str, Any]] = None,
              leaves: Optional[Dict[str, Any]] = None) -> None:
    """Checkpoint the resume closure: state, the generator state that
    draws the next epoch's plan, the epoch counter, history and the
    converged flag (a resumed fit stops where the uninterrupted one
    stopped).  ``leaves`` (``ExecutionPlan.snapshot_leaves``: BCD's
    residual) join the tree.  ``extra_fields`` is merged into ``extra``:
    the solver stores the serialized preconditioner there, so a resumed
    preconditioned fit replays the same correction."""
    tree = {"alpha": state.alpha, "accum": state.accum,
            "step": state.step, "epoch": state.epoch,
            "gen_state": gen_state}
    tree.update(leaves or {})
    extra = {"epoch": epoch, "history": history, "converged": converged}
    extra.update(extra_fields or {})
    manager.save(epoch, tree, extra=extra)


def _restore(manager, plan: ExecutionPlan,
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


def fit_loop(plan: ExecutionPlan, generator: Optional[torch.Generator], *,
             plans: Optional[Sequence] = None, n_epochs: int = 50,
             tol: float = 1e-3, x_val: Optional[Tensor] = None,
             y_val: Optional[Tensor] = None, eval_every: int = 1,
             verbose: bool = False, truncate_every: int = 0,
             truncate_frac: float = 0.1,
             callback: Optional[Callable[[int, DSEKLState], None]] = None,
             manager=None, checkpoint_every: int = 1, resume: bool = False,
             snapshot_extra: Optional[Dict[str, Any]] = None,
             on_epoch: Optional[
                 Callable[[int, DSEKLState, Dict[str, Any]], Any]] = None
             ) -> FitResult:
    """Drive an ``ExecutionPlan`` to convergence (paper §4.2: ``|dalpha| <
    tol`` over one epoch) or ``n_epochs``: epoch -> truncate -> eval ->
    snapshot.

    Epoch e runs on ``plans[e]`` when ``plans`` is given, else on a plan
    drawn from ``generator``.  The plan of epoch e + 1 is drawn (or taken)
    and handed to ``plan.plan_epoch`` before epoch e runs, so a hosted
    backend's prefetcher streams across the boundary.  An epoch is
    evaluated on the ``eval_every`` cadence, and always on the last record
    of the fit (the final epoch or the convergence epoch).  With a
    ``CheckpointManager`` the loop snapshots every ``checkpoint_every``
    epochs and at the end; ``resume=True`` restores the newest valid
    snapshot and continues as a run that was never interrupted.
    ``on_epoch(epoch, state, record)`` returning truthy stops the fit
    after that boundary's snapshot.  ``snapshot_extra`` rides in every
    snapshot's ``extra``."""
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
            if verbose and plan.is_lead:
                print(f"[dsekl] resumed at epoch {start} ({plan.name} "
                      "backend)" + (" — already converged" if converged
                                    else ""))

    def take(e):
        return plans[e] if plans is not None else plan.draw_plan(generator)

    hook_stop = False
    if start < n_epochs:
        with tracing.span("repro_torch.fit.plan"):
            current = take(start)
            plan.plan_epoch(current)
    for e in range(start, n_epochs):
        gen_state = _gen_state(generator)       # draws epoch e + 1's plan
        with tracing.span("repro_torch.fit.plan"):
            upcoming = take(e + 1) if e + 1 < n_epochs else None
            if upcoming is not None:
                plan.plan_epoch(upcoming)       # one epoch ahead
        prev_alpha = state.alpha
        t0 = time.perf_counter()
        with tracing.span("repro_torch.fit.epoch"):
            state = plan.run_epoch(state, current)
            if truncate_every and (e + 1) % truncate_every == 0:
                state = plan.truncate(state, truncate_frac)
            _sync(state.alpha)
        dt = time.perf_counter() - t0
        with tracing.span("repro_torch.fit.delta"):
            delta = plan.delta_norm(state.alpha, prev_alpha)
        converged = delta < tol
        rec: Dict[str, Any] = {"epoch": e + 1, "delta_alpha": delta,
                               "seconds": dt}
        if x_val is not None and (e % eval_every == 0 or converged
                                  or e == n_epochs - 1):
            with tracing.span("repro_torch.fit.eval"):
                rec["val_error"] = plan.eval_error(state, x_val, y_val)
        history.append(rec)
        with tracing.span("repro_torch.fit.on_epoch"):
            if callback is not None:
                callback(e, state)
            hook_stop = bool(on_epoch(e + 1, state, rec)) \
                if on_epoch is not None else False
        if verbose and plan.is_lead:
            print(f"[dsekl] epoch {e + 1}: |dalpha|={delta:.4f} "
                  + (f"val_err={rec['val_error']:.4f}"
                     if "val_error" in rec else ""))
        if manager is not None and (
                (e + 1) % checkpoint_every == 0 or converged or hook_stop
                or e == n_epochs - 1):
            # Every rank of a mesh joins the gathers; rank 0 writes.
            with tracing.span("repro_torch.fit.snapshot"):
                full, leaves = plan.snapshot_state(state), \
                    plan.snapshot_leaves(state)
                if plan.is_lead:
                    _snapshot(manager, full, gen_state, e + 1, history,
                              converged, snapshot_extra, leaves=leaves)
        current = upcoming
        if converged or hook_stop:
            break
    if manager is not None:
        manager.wait()
        plan.barrier()              # rank 0's last write is on disk
    return FitResult(state=state, history=history, converged=converged,
                     epochs_run=len(history),
                     val_cache=plan.val_cache_info(),
                     loader=plan.loader_stats(),
                     stop_reason=("converged" if converged
                                  else "hook" if hook_stop else "epochs"),
                     epochs_to_tol=next(
                         (h["epoch"] for h in history
                          if h["delta_alpha"] < tol), None),
                     final_residual=(history[-1]["delta_alpha"]
                                     if history else 0.0))


def resolve_execution(execution: Optional[str], cfg: DSEKLConfig, *,
                      algorithm: str = "serial", hosted_data: bool = False,
                      mesh=None) -> str:
    """``execution=None`` defers to ``cfg.execution``; ``"auto"`` picks
    ``mesh`` when a mesh is given, ``hosted`` for a host-resident source,
    else the in-memory backend of ``algorithm``."""
    execution = execution if execution is not None else cfg.execution
    if execution not in EXECUTIONS:
        raise ValueError(f"unknown execution {execution!r}; "
                         f"one of {EXECUTIONS}")
    if algorithm not in ("serial", "parallel"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if execution == "auto":
        if mesh is not None:
            return "mesh"
        return "hosted" if hosted_data else algorithm
    return execution


def default_mesh(device: torch.device):
    """``make_plan``'s mesh when none is given (JAX's is a mesh of the
    local devices): (world, 1) over an initialised world, else a world of
    one that the plan tears down on ``close()``; nccl on the card, gloo on
    the CPU, as the launcher defaults.  Returns ``(mesh, owned)``."""
    from repro_torch.launch.mesh import make_local_mesh
    if tdist.is_initialized():
        return make_local_mesh(tdist.get_world_size(), 1,
                               backend=tdist.get_backend(),
                               device=device), False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    mesh = make_local_mesh(1, 1, backend=backend, device=device)
    return mesh, True


def make_plan(execution: str, cfg: DSEKLConfig, *,
              x: Optional[Tensor] = None, y: Optional[Tensor] = None,
              source=None, algorithm: str = "serial", prefetch: bool = True,
              eval_cache: bool = False,
              device: Optional[torch.device] = None,
              precond=None, mesh=None,
              owns_mesh: bool = False) -> ExecutionPlan:
    """The backend for a resolved ``execution``: ``SerialPlan`` /
    ``ParallelPlan`` over device tensors, ``HostedPlan`` or ``BCDPlan``
    over a ``DataSource`` (its state on ``device``), ``MeshPlan`` (and
    ``BCDPlan`` given ``mesh``) on the rank's mesh device.  ``mesh``
    defaults for ``"mesh"`` to ``default_mesh``; ``owns_mesh`` hands a
    given mesh's teardown to the plan.  ``precond`` is an
    ``EigenProPreconditioner``, staged here to a ``dsekl.PrecondBlock`` on
    the plan's device (on a mesh, broadcast from rank 0), or None (no
    preconditioning; ``bcd`` takes none)."""
    if execution in ("serial", "parallel"):
        if x is None:
            raise ValueError(
                f"execution={execution!r} needs device-resident tensors; "
                "a host-resident DataSource trains via 'hosted'")
        plan_cls = SerialPlan if execution == "serial" else ParallelPlan
        pc = precond.block(x.device) if precond is not None else None
        return plan_cls(cfg, x, y, eval_cache=eval_cache, precond=pc)
    if execution == "hosted":
        if source is None:
            raise ValueError("execution='hosted' needs a DataSource")
        if device is None:
            raise ValueError("execution='hosted' needs the state's device")
        pc = precond.block(device) if precond is not None else None
        return HostedPlan(cfg, source, algorithm=algorithm,
                          prefetch=prefetch, device=device, precond=pc)
    if execution == "mesh":
        if source is None:
            raise ValueError("execution='mesh' needs a DataSource "
                             "(wrap arrays in InMemorySource)")
        if mesh is None:
            mesh, owns_mesh = default_mesh(device or torch.device("cuda"))
        try:
            pc = distributed.broadcast_block(
                mesh, precond.block(mesh.device)
                if precond is not None else None)
            return MeshPlan(cfg, source, mesh, prefetch=prefetch,
                            precond=pc, owns_mesh=owns_mesh)
        except BaseException:
            if owns_mesh:
                mesh.close()
            raise
    if execution == "bcd":
        if source is None:
            raise ValueError("execution='bcd' needs a DataSource "
                             "(wrap arrays in InMemorySource)")
        if device is None and mesh is None:
            raise ValueError("execution='bcd' needs the state's device")
        if precond is not None:
            raise ValueError(
                "execution='bcd' solves each block exactly — EigenPro "
                "preconditioning applies to the stochastic step only")
        return BCDPlan(cfg, source, prefetch=prefetch, device=device,
                       mesh=mesh, owns_mesh=owns_mesh)
    raise ValueError(f"unknown execution {execution!r}")
