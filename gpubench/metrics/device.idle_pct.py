"""device.idle_pct: the share of the traced window in which no device
operation ran (the union of device intervals, from the profiler's trace)."""


def read(ctx):
    w = ctx.window
    if w is None or not w.device or w.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
