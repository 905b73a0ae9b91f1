"""Fit loop and op dispatch: the median host time of one training step,
us: the program's ``repro_torch.fit.step`` spans in the traced span (the
profiler's clock; a number on the CPU too)."""
from portbench.harness import spans


def read(ctx):
    win = ctx.window
    if win.trace is None:
        return None
    return spans.median_us(win.trace, "repro_torch.fit.step")
