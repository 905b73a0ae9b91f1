"""Fit loop and op dispatch: the card's idle time whose gap middle lies
inside a ``repro_torch.fit.eval`` span (the epoch's validation eval),
over those spans, ms."""
from portbench.harness import spans

EVAL = "repro_torch.fit.eval"


def read(ctx):
    win = ctx.window
    if win.trace is None:
        return None
    s = spans.idle_per_span(win.trace, EVAL, EVAL)
    return None if s is None else 1e3 * s
