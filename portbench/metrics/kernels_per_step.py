"""Fit loop and op dispatch: device kernels in the traced span (the
profiler's kernel events, the evals' included) over the training steps
in it."""


def read(ctx):
    win = ctx.window
    if win.trace is None or not win.span or not win.span.get("steps"):
        return None
    return len(win.trace.kernels()) / win.span["steps"]
