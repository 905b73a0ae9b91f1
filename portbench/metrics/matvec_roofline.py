"""Kernels: the matvec launches' share of their roofline, %.  The bound
of each launch the benchmark counts from the traced span's tiles (real
query rows, the unpadded support set; ``harness/work.py``) over the
profiler's device time of the kernels the matvec launches."""
from portbench.harness import roofline

FAMILY = "matvec"


def read(ctx):
    win = ctx.window
    if win.trace is None or not win.span or not win.span.get("matvec_work"):
        return None
    return roofline.share(win.trace, FAMILY, win.span["matvec_work"],
                          ctx.peaks)
