"""Device, training: the share of the traced span in which no device
operation ran, %, in the cells that report ``train_rows_per_s``."""
from portbench.harness import trace


def read(ctx):
    return trace.idle_percent(ctx.window, "train_rows_per_s")
