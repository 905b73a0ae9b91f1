"""Faults planted under the timed path, for the checks' controls: each must
turn ``correct`` false.

* ``state_unchanged``: a training step returns its state as it got it.
* ``half_batch``: a training step's gradient rows are the first half of
  I twice over (half the batch left out, the sum, which DSEKL's step takes
  where a mean would be, made up from the rest).
* ``half_support``: a serve call sums over the first half of the support
  rows twice over (half the batch of support rows left out).
* ``answer_altered``: one answer of every serve call is moved by one,
  where the matvec produces it.

Each patches a module attribute of the program that the timed path calls
through, and restores it on exit.  ``after``: the first ``after`` calls
pass through unbroken, so that the fault starts inside the window, as a
change that only takes effect once set-up has warmed it would."""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

FAULTS = ("state_unchanged", "half_batch", "half_support", "answer_altered")


@contextlib.contextmanager
def planted(name: str, after: int = 0) -> Iterator[None]:
    from repro_torch.core import dsekl
    from repro_torch.kernels.dsekl import ops
    if name in ("state_unchanged", "half_batch"):
        module, attr = dsekl, "step_serial"
    elif name in ("half_support", "answer_altered"):
        module, attr = ops, "kernel_matvec_tiled"
    else:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    orig = getattr(module, attr)

    def state_unchanged(cfg, state, *args, **kw):
        return state

    def half_batch(cfg, state, x, y, idx_i, idx_j, *args, **kw):
        half = idx_i[: idx_i.shape[0] // 2]
        return orig(cfg, state, x, y, torch.cat([half, half]), idx_j,
                    *args, **kw)

    def half_support(xq, z, a, **kw):
        h = z.shape[0] // 2
        return 2.0 * orig(xq, z[:h], a[:h], **kw)

    def answer_altered(xq, z, a, **kw):
        f = orig(xq, z, a, **kw).clone()
        f[0] += 1.0
        return f

    broken = locals()[name]
    calls = [0]

    def fault(*args, **kw):
        calls[0] += 1
        return (orig if calls[0] <= after else broken)(*args, **kw)

    setattr(module, attr, fault)
    try:
        yield
    finally:
        setattr(module, attr, orig)
