"""step.device_ops: device operations (kernels, copies, sets) a loop step
runs, from the profiler's trace of the traced steps."""


def read(ctx):
    w = ctx.window
    return w.ops_per_step if w is not None and w.device else None
