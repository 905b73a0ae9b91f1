"""Serving engine: the median host time of one ``flush_async`` call over
the window's rounds (the benchmark's own span around each call, host
clock), ms."""
import numpy as np


def read(ctx):
    flush = ctx.window.counts.get("flush_ms")
    if flush is None or len(flush) == 0:
        return None
    return float(np.median(flush))
