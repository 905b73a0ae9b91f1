"""One run of one cell: set-up, the measured window (and, with ``--trace
1``, a traced span after it), the peak memory, the correctness check,
the metrics and the result line.

A traffic kind (``traffic/<kind>.py``) provides

* ``setup(ctx) -> state``: the data, the program's objects and the
  warm-up of every shape the window uses;
* ``window(ctx, state) -> Window``: the measured window, then, with
  ``ctx.trace``, the traced span through ``ctx.tracer``;
* ``readings(ctx, state, tf32_control=False) -> {name: number}``: frees
  the program's state, then every number the check computes against the
  plain reference (the control in the program's place when asked);
* ``check(ctx, state, window) -> [Check]``: the readings the cell's
  limits name, each beside its limit.

A per-layer reader (``metrics/<metric>.py``) provides ``read(ctx) ->
float | None`` over the ``Window`` and the trace's ``Summary``."""
from __future__ import annotations

import dataclasses
import math
import pathlib
from typing import Any, Dict, List, Optional

import torch

from portbench.harness import spec, work
from portbench.harness.trace import Summary, Tracer


@dataclasses.dataclass
class Check:
    """One number compared with its limit; it passes at or under it."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Window:
    """What a kind's window measured and counted."""
    started: float                  # perf_counter at the window's start
    seconds: float                  # the window's length, host clock
    attempted: int                  # requests (serve) or steps (train)
    failed: int
    end_to_end: Dict[str, float]    # the kind's end-to-end metrics
    counts: Dict[str, Any]          # the window's own counts for readers
    span: Optional[Dict[str, Any]] = None   # the traced span's counts
    trace: Optional[Summary] = None


@dataclasses.dataclass
class Context:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    peaks: work.Peaks
    shrink: Optional[Dict[str, int]] = None     # CPU tests: smaller sizes
    tracer: Optional[Tracer] = None
    window: Optional[Window] = None

    def size(self, key: str) -> int:
        """A size of the configuration or the traffic, or its smaller
        stand-in in a CPU test."""
        if self.shrink and key in self.shrink:
            return int(self.shrink[key])
        if key in self.cell.config:
            return int(self.cell.config[key])
        return int(self.cell.traffic[key])

    def sub_seed(self, tag: int) -> int:
        """A seed for one purpose, derived from the run's ``--seed``."""
        return (self.seed * 0x9E3779B1 + tag * 0x85EBCA77) % (1 << 62)


def trace_path(cell: str) -> pathlib.Path:
    return spec.ROOT / "build" / "portbench" / f"{cell}.trace.json"


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
        device: torch.device, card: str, t_start: float,
        shrink: Optional[Dict[str, int]] = None) -> dict:
    """Run ``cell`` once on ``device`` (the card named ``card``); returns
    the result line's object, the checks under its last key."""
    kind = cell.kind()
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                  device=device, peaks=work.peaks_for(card), shrink=shrink,
                  tracer=Tracer(trace_path(cell.name)) if trace else None)
    state = kind.setup(ctx)
    win = ctx.window = kind.window(ctx, state)
    setup_s = win.started - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    checks: List[Check] = kind.check(ctx, state, win)
    del state
    e2e = dict(win.end_to_end, setup_s=setup_s)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m.name).read(ctx)
            if value is not None:
                metrics[m.name] = {"value": float(value), "unit": m.unit}
    else:
        metrics = {m.name: {"value": float(e2e[m.name]), "unit": m.unit}
                   for m in cell.end_to_end}
    failed = win.failed
    correct = failed == 0 and all(c.ok for c in checks) and bool(checks)
    out = {"correct": correct, "attempted": win.attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else
                      device.type, "kind": card, "count": cell.chips,
                      "memory_peak_bytes": int(peak)}}
    if trace:
        out["device"].update(busy_s=win.trace.busy_s,
                             window_s=win.trace.window_s)
        out["breakdown"] = {"device_ops": win.trace.device_ops(),
                            "idle_gaps": win.trace.idle_gaps()}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return out
