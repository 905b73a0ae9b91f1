"""Kernels: the train pass's share of its roofline, %.  Each step's
bound (``harness/work.py``) over the profiler's device time of the
kernels the train pass launches."""
from portbench.harness import roofline

FAMILY = "train_pass"


def read(ctx):
    win = ctx.window
    if win.trace is None or not win.span or not win.span.get("train_work"):
        return None
    return roofline.share(win.trace, FAMILY, win.span["train_work"],
                          ctx.peaks)
