"""Fault-tolerant LM training loop: checkpoint / restart, straggler
watchdog, exact resume (port of ``repro/train/loop.py``).

A crash at any step resumes bit for bit: the data pipeline's step is part
of the checkpoint, the write is atomic, and the model and optimizer state
fully determine the trajectory.  ``SimulatedFailure`` and
``fail_at_step`` are the test hook that proves it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager, unflatten_into
from repro_torch.data.pipeline import BigramPipeline, to_device
from repro_torch.device import DeviceLike, resolve_device


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


def _save(ckpt: CheckpointManager, step: int, params, opt_state,
          pipeline: BigramPipeline) -> None:
    ckpt.save(step, {"params": params, "opt": opt_state},
              extra={"pipeline": pipeline.state_dict(), "train_step": step})


def train_loop(train_step: Callable, params: Dict[str, torch.Tensor],
               opt_state: dict, pipeline: BigramPipeline,
               ckpt: Optional[CheckpointManager],
               loop_cfg: TrainLoopConfig, *, resume: bool = True,
               fail_at_step: Optional[int] = None,
               device: DeviceLike = None,
               verbose: bool = False) -> Dict[str, Any]:
    """Runs (or resumes) the loop; returns {params, opt_state, history}.

    ``params`` are the model's parameters (``train.trainable``): a resume
    copies the checkpoint's values into them in place.  Each batch goes to
    ``device`` (default ``cuda``) as int64 tensors.  Each history record
    holds the step's metrics as floats (reading them ends in a device
    synchronisation), ``step``, ``seconds`` (host clock around the step
    and that read) and, past five steps, ``straggler`` when the step took
    more than ``watchdog_factor`` x the running median."""
    dev = resolve_device(device)
    start_step = 0
    if ckpt is not None and resume:
        try:                        # the newest valid step, checksummed once
            _, flat, extra = ckpt.restore()
        except FileNotFoundError:   # none yet: a fresh start
            flat = None
        if flat is not None:
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
            _save(ckpt, step + 1, params, opt_state, pipeline)
    if ckpt is not None:
        # The final state, unless the periodic save just wrote it (JAX
        # writes that step a second time).
        if not history or loop_cfg.n_steps % loop_cfg.ckpt_every:
            _save(ckpt, loop_cfg.n_steps, params, opt_state, pipeline)
        ckpt.wait()
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
