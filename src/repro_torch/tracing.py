"""Named spans of the port's host layers, for ``torch.profiler``.

``span(name)`` marks a stretch of host code as one
``torch.profiler.record_function`` range while a profiler records this
thread, so the range lands in the profiler's trace beside the CPU ops and
the device's kernels and copies, on their clock.  With no profiler on it
returns one shared null context: the cost is a flag check.  There is no
switch: any ``torch.profiler.profile`` session sees the spans.

Every name is fixed and starts with ``repro_torch.``; a name carries no
ids or sizes, so a trace's totals group by name.  The serving engine's
spans are ``repro_torch.engine.*``, the fit loop's ``repro_torch.fit.*``
(README.md, "Tracing the port", lists them)."""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` context while a profiler is on, else
    the shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
