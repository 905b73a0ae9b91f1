"""Device, serving: the share of the traced span in which no device
operation ran, %, in the cells that report ``serve_qps``."""
from portbench.harness import trace


def read(ctx):
    return trace.idle_percent(ctx.window, "serve_qps")
