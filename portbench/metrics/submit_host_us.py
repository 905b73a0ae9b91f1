"""Serving engine: the median host time of one ``submit`` call, us: the
program's ``repro_torch.engine.submit`` spans in the traced span (the
profiler's clock; a number on the CPU too)."""
from portbench.harness import spans


def read(ctx):
    win = ctx.window
    if win.trace is None:
        return None
    return spans.median_us(win.trace, "repro_torch.engine.submit")
