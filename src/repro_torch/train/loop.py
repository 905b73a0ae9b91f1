"""Fault-tolerant LM training loop: checkpoint / restart, straggler
watchdog, exact resume (port of ``repro/train/loop.py``).

A crash at any step resumes bit for bit: the data pipeline's step is part
of the checkpoint, the write is atomic, and the model and optimizer state
fully determine the trajectory.  ``SimulatedFailure`` and
``fail_at_step`` are the test hook that proves it.

On a mesh (``shards``, ``train.param_shards(model)``) the checkpoint is
the single-device one: every rank gathers its slices of the parameters
and moments whole (``nn.module.gather_whole``), rank 0 alone writes, and
a resume takes each rank's slices of the whole arrays
(``nn.module.take_local``).  So a mesh checkpoint resumes on one device
or on another mesh shape, and a one-device checkpoint on a mesh.  Every
rank draws the same global batch from the pipeline (the model takes its
data shard).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager, unflatten_into
from repro_torch.data.pipeline import BigramPipeline, to_device
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.module import gather_whole, take_local


class SimulatedFailure(RuntimeError):
    """Raised by the test hook to emulate a node failure."""


@dataclasses.dataclass
class TrainLoopConfig:
    n_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    # Watchdog: steps slower than watchdog_factor x the running median are
    # logged as stragglers (on a real pod this feeds the preemption logic).
    watchdog_factor: float = 3.0


def _on_mesh(shards) -> bool:
    return shards is not None and shards.ctx is not None


def _whole(tree, shards):
    """``tree`` (params or optimizer state, nested by name) with every
    parameter-shaped leaf gathered whole."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _whole(v, shards)
        elif k in shards.specs:
            out[k] = gather_whole(v, shards.specs[k], shards.ctx)
        else:
            out[k] = v
    return out


def _save(ckpt: CheckpointManager, step: int, params, opt_state,
          pipeline: BigramPipeline, shards=None) -> None:
    tree = {"params": params, "opt": opt_state}
    if _on_mesh(shards):
        tree = _whole(tree, shards)
        if shards.ctx.mesh.rank != 0:
            return
    ckpt.save(step, tree,
              extra={"pipeline": pipeline.state_dict(), "train_step": step})


def _local_flat(flat, shards):
    """A whole checkpoint's flat arrays cut to this rank's slices."""
    out = {}
    for key, arr in flat.items():
        name = key.rsplit("/", 1)[-1]
        if name in shards.specs:
            arr = take_local(torch.from_numpy(arr), shards.specs[name],
                             shards.ctx).contiguous().numpy()
        out[key] = arr
    return out


def train_loop(train_step: Callable, params: Dict[str, torch.Tensor],
               opt_state: dict, pipeline: BigramPipeline,
               ckpt: Optional[CheckpointManager],
               loop_cfg: TrainLoopConfig, *, resume: bool = True,
               fail_at_step: Optional[int] = None,
               device: DeviceLike = None,
               verbose: bool = False, shards=None) -> Dict[str, Any]:
    """Runs (or resumes) the loop; returns {params, opt_state, history}.

    ``params`` are the model's parameters (``train.trainable``): a resume
    copies the checkpoint's values into them in place.  Each batch goes to
    ``device`` (default ``cuda``) as int64 tensors.  Each history record
    holds the step's metrics as floats (reading them ends in a device
    synchronisation), ``step``, ``seconds`` (host clock around the step
    and that read) and, past five steps, ``straggler`` when the step took
    more than ``watchdog_factor`` x the running median.  On a mesh
    (``shards``) rank 0 alone prints and writes (module docstring)."""
    dev = resolve_device(device)
    mesh = _on_mesh(shards)
    verbose = verbose and (not mesh or shards.ctx.mesh.rank == 0)
    start_step = 0
    if ckpt is not None and resume:
        try:                        # the newest valid step, checksummed once
            _, flat, extra = ckpt.restore()
        except FileNotFoundError:   # none yet: a fresh start
            flat = None
        if flat is not None:
            if mesh:
                flat = _local_flat(flat, shards)
            state = unflatten_into({"params": params, "opt": opt_state},
                                   flat)
            del flat
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(state["params"][k])
            opt_state = state["opt"]
            pipeline.load_state_dict(extra["pipeline"])
            start_step = int(extra["train_step"])

    history: List[Dict[str, float]] = []
    durations: List[float] = []
    for step in range(start_step, loop_cfg.n_steps):
        if fail_at_step is not None and step == fail_at_step:
            raise SimulatedFailure(f"simulated node failure at step {step}")
        batch = to_device(pipeline.next_batch(), dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        durations.append(dt)
        med = sorted(durations)[len(durations) // 2]
        if dt > loop_cfg.watchdog_factor * med and len(durations) > 5:
            metrics["straggler"] = dt / med
        metrics["step"] = step
        metrics["seconds"] = dt
        history.append(metrics)
        if verbose and step % loop_cfg.log_every == 0:
            print(f"[train] step {step}: loss={metrics['loss']:.4f} "
                  f"({dt * 1e3:.0f} ms)")
        if ckpt is not None and (step + 1) % loop_cfg.ckpt_every == 0:
            _save(ckpt, step + 1, params, opt_state, pipeline, shards)
    if ckpt is not None:
        # The final state, unless the periodic save just wrote it (JAX
        # writes that step a second time).
        if not history or loop_cfg.n_steps % loop_cfg.ckpt_every:
            _save(ckpt, loop_cfg.n_steps, params, opt_state, pipeline,
                  shards)
        ckpt.wait()
        if mesh:            # rank 0's checkpoint is on disk for every rank
            import torch.distributed as dist
            dist.barrier()
    return {"params": params, "opt_state": opt_state, "history": history}


def run_with_restarts(make_loop: Callable[[], Dict[str, Any]],
                      max_restarts: int = 3,
                      verbose: bool = False) -> Dict[str, Any]:
    """Launcher-level retry: restart from the last checkpoint on failure.

    ``make_loop`` must build fresh state and call ``train_loop`` with
    ``resume=True``; this models a cluster scheduler relaunching a failed
    job."""
    for attempt in range(max_restarts + 1):
        try:
            return make_loop()
        except SimulatedFailure as e:
            if verbose:
                print(f"[launcher] {e}; restarting "
                      f"({attempt + 1}/{max_restarts})")
            if attempt == max_restarts:
                raise
    raise AssertionError("unreachable")
