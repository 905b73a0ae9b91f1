"""The program's own spans in a traced span: the ``repro_torch.*`` user
annotations that ``repro_torch.tracing`` records under the profiler (on
the trace's clock, beside the device's events), their durations, and the
card's idle time that lies inside them.

An idle gap is a stretch of ``[t0, t1]`` outside the union of the
device's intervals; it counts inside a span when its middle does, the
rule ``Summary.idle_gaps`` names gaps by.  The idle readings are None
when the span holds no device event (a run on the CPU); the host's spans
exist without a card."""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

import numpy as np

from portbench.harness.trace import Event, Summary, _union

PROGRAM = "repro_torch."


def program_spans(summary: Summary, prefix: str = PROGRAM) -> List[Event]:
    """The user annotations in the span whose names start with
    ``prefix``."""
    return [e for e in summary.host if e.cat == "user_annotation"
            and e.name.startswith(prefix)]


def durations(summary: Summary, name: str) -> List[float]:
    """The durations, us, of the spans called ``name``."""
    return [e.dur for e in program_spans(summary, name) if e.name == name]


def _gaps(summary: Summary) -> List[Tuple[float, float]]:
    gaps, at = [], summary.t0
    for a, b in summary.busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if summary.t1 > at:
        gaps.append((at, summary.t1))
    return gaps


def idle_in(summary: Summary, prefix: str) -> Optional[float]:
    """The device's idle time, s, in the gaps whose middle lies inside a
    span whose name starts with ``prefix``; None without device events."""
    if not summary.device:
        return None
    cover = _union([(e.ts, e.end) for e in program_spans(summary, prefix)])
    starts = [a for a, _ in cover]
    total = 0.0
    for a, b in _gaps(summary):
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(starts, mid) - 1
        if k >= 0 and mid <= cover[k][1]:
            total += b - a
    return total * 1e-6


def median_us(summary: Summary, name: str) -> Optional[float]:
    """The median duration, us, of the spans called ``name``; None
    without one."""
    d = durations(summary, name)
    return float(np.median(d)) if d else None


def idle_per_span(summary: Summary, prefix: str,
                  name: str) -> Optional[float]:
    """``idle_in(prefix)`` over the number of spans called ``name``, s;
    None without device events or without such a span."""
    idle, n = idle_in(summary, prefix), len(durations(summary, name))
    return idle / n if idle is not None and n else None
