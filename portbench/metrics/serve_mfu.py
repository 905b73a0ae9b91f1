"""Whole serve step: the window's model FLOPs (every answered query's
products against the unpadded support set) over the window's length
times the dense TF32 peak, %."""


def read(ctx):
    win = ctx.window
    if "serve_qps" not in win.end_to_end:
        return None
    return 100.0 * win.counts["model_flops"] / (win.seconds
                                                * ctx.peaks.tf32_flops)
