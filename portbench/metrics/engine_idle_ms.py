"""Serving engine: the card's idle time whose gap middle lies inside one
of the program's ``repro_torch.engine.*`` spans, over the traced span's
``repro_torch.engine.flush`` spans (one a round), ms."""
from portbench.harness import spans


def read(ctx):
    win = ctx.window
    if win.trace is None:
        return None
    s = spans.idle_per_span(win.trace, "repro_torch.engine.",
                            "repro_torch.engine.flush")
    return None if s is None else 1e3 * s
