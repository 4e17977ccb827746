"""loop.step_ms_p90: the 90th percentile of run_pretrain's own loop-step
times (info["step_s"], each from the end of one step's dispatch to the
next's, its batch wait included) over the window's steps, in ms."""

import statistics


def read(ctx):
    steps = ctx.window_step_s
    if len(steps) < 2:
        return None
    return statistics.quantiles(steps, n=10, method="inclusive")[8] * 1e3
