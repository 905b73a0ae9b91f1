"""The traced span of a ``--trace 1`` run: ``torch.profiler`` over the CPU
and the card, its chrome trace written under the checkout and read back
into the device's intervals, the host's activity beside them and the
span's own bounds (a ``portbench.span`` annotation)."""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import pathlib
from typing import Dict, List, Optional, Tuple

import torch

SPAN = "portbench.span"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Event:
    name: str
    cat: str
    ts: float               # us, the trace's clock
    dur: float              # us
    tid: object = None
    correlation: Optional[int] = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclasses.dataclass
class Summary:
    """What the span holds: its bounds, the device's events in it and the
    host's, and the union of the device's busy intervals."""
    t0: float
    t1: float
    device: List[Event]
    host: List[Event]
    busy: List[Tuple[float, float]]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def kernels(self) -> List[Event]:
        return [e for e in self.device if e.cat == "kernel"]

    def kernels_under(self, op: str) -> List[Event]:
        """The kernels whose launch call (matched by correlation id) ran
        inside a host op called ``op`` on the same thread."""
        spans: Dict[object, List[Tuple[float, float]]] = \
            collections.defaultdict(list)
        for e in self.host:
            if e.cat == "cpu_op" and e.name == op:
                spans[e.tid].append((e.ts, e.end))
        for v in spans.values():
            v.sort()
        inside = set()
        for e in self.host:
            if e.cat not in ("cuda_runtime", "cuda_driver") \
                    or e.correlation is None or e.tid not in spans:
                continue
            v = spans[e.tid]
            k = bisect.bisect_right(v, (e.ts, float("inf"))) - 1
            if k >= 0 and v[k][0] <= e.ts and e.end <= v[k][1]:
                inside.add(e.correlation)
        return [e for e in self.kernels() if e.correlation in inside]

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time: [name, seconds]."""
        total: Dict[str, float] = collections.defaultdict(float)
        for e in self.device:
            total[e.name[:160]] += e.dur * 1e-6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The device's idle time in the span by what the host was doing
        at each gap's middle (the innermost host event there): [name,
        seconds], the largest first."""
        gaps, at = [], self.t0
        for a, b in self.busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            gaps.append((at, self.t1))
        host = sorted((e for e in self.host if e.name != SPAN),
                      key=lambda e: e.ts)
        starts = [e.ts for e in host]
        total: Dict[str, float] = collections.defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            k = bisect.bisect_right(starts, mid)
            inner = None
            for e in host[max(0, k - 256):k]:
                if e.end >= mid and (inner is None or e.dur < inner.dur):
                    inner = e
            total[inner.name[:160] if inner is not None else "python"] += \
                (b - a) * 1e-6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]


def idle_percent(win, moves: str) -> Optional[float]:
    """The device readers' shared reading: the share of the traced span in
    which no device operation ran, 1 - (union of the device's intervals /
    span), %, for a window that reports the end-to-end metric ``moves``;
    None without a trace or that metric."""
    if win.trace is None or moves not in win.end_to_end:
        return None
    return 100.0 * (1.0 - win.trace.busy_s / win.trace.window_s)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _correlation(args: dict) -> Optional[int]:
    for key in ("correlation", "correlation id", "External id"):
        if key in args:
            return int(args[key])
    return None


def read(path: pathlib.Path) -> Summary:
    """The span's summary from a chrome trace that holds one ``SPAN``
    annotation; device events are clipped to it."""
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == SPAN
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise ValueError(f"{path.name}: {len(spans)} {SPAN} annotations")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    device, host = [], []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in DEVICE_CATS + HOST_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        ev = Event(e.get("name", ""), cat, ts, dur, e.get("tid"),
                   _correlation(e.get("args", {})))
        if cat in DEVICE_CATS:
            a, b = max(ts, t0), min(ts + dur, t1)
            if b > a:
                device.append(dataclasses.replace(ev, ts=a, dur=b - a))
        elif ts < t1 and ts + dur > t0:
            host.append(ev)
    busy = _union([(e.ts, e.end) for e in device])
    return Summary(t0, t1, device, host, busy)


class Tracer:
    """``torch.profiler`` over the CPU and the card between ``start()`` and
    ``stop()``, the span annotated; ``stop()`` synchronises the card,
    writes the chrome trace to ``path`` and returns its ``Summary``."""

    def __init__(self, path: pathlib.Path):
        self.path = path
        self._prof = None
        self._span = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._span = record_function(SPAN)
        self._span.__enter__()

    def stop(self) -> Summary:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        return read(self.path)
