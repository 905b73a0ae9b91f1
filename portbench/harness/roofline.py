"""A kernel family's share of its roofline over a traced span: the sum of
the bounds of the launches the benchmark counted in the span over the
profiler's device time of the family's kernels there.

A family is the kernels its launches put on the card, found in the
trace by what the program names: the kernels launched inside the host
op ``repro_torch::kernel_matvec`` (the matvec's, on either route), and
the train pass's kernels by name (one cluster launch on the sm90 route,
its tiles, rows and columns passes on the fp32 one)."""
from __future__ import annotations

import re
import sys
from typing import List, Optional

from portbench.harness.trace import Event, Summary
from portbench.harness.work import Peaks, Work

OPS = {"matvec": "repro_torch::kernel_matvec"}
NAMES = {"train_pass": re.compile(r"train_sm90|train_tiles|train_rows|"
                                  r"train_cols")}


def kernels(summary: Summary, family: str) -> List[Event]:
    if family in OPS:
        return summary.kernels_under(OPS[family])
    pattern = NAMES[family]
    return [e for e in summary.kernels() if pattern.search(e.name)]


def share(summary: Summary, family: str, launches: List[Work],
          peaks: Peaks) -> Optional[float]:
    """100 x (sum of the launches' bounds) / (device time of the family's
    kernels in the span); None when the trace holds none of them."""
    found = kernels(summary, family)
    busy_us = sum(e.dur for e in found)
    if busy_us <= 0:
        print(f"[portbench] {family}: no kernel in the traced span",
              file=sys.stderr)
        return None
    bound_s = sum(w.bound_s(peaks) for w in launches)
    return 100.0 * bound_s / (busy_us * 1e-6)
