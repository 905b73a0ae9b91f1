"""Whole training step: the window's model FLOPs (every step's train-pass
products; the evals' are left out) over the window's length times the
dense TF32 peak, %."""


def read(ctx):
    win = ctx.window
    if "train_rows_per_s" not in win.end_to_end:
        return None
    return 100.0 * win.counts["model_flops"] / (win.seconds
                                                * ctx.peaks.tf32_flops)
