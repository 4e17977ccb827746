"""step_mfu: the model FLOPs of the traced steps (counts.step_flops over
the plain reference model at the cell's shapes) over the traced window's
time (the profiler's trace), as a share of one H100's dense bf16 peak."""

from gpubench.counts import BF16_PEAK_FLOPS


def read(ctx):
    w = ctx.window
    if w is None or not w.device or w.window_s <= 0:
        return None
    return 100.0 * ctx.counts["flops"] * w.steps / w.window_s / BF16_PEAK_FLOPS
