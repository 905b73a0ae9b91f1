"""Fit loop and op dispatch: the card's idle time whose gap middle lies
inside a ``repro_torch.fit.step`` span, over those spans, us."""
from portbench.harness import spans

STEP = "repro_torch.fit.step"


def read(ctx):
    win = ctx.window
    if win.trace is None:
        return None
    s = spans.idle_per_span(win.trace, STEP, STEP)
    return None if s is None else 1e6 * s
