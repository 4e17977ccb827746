"""device.reserved_peak_gib: the most device memory that the program's
caching allocator reserved over the window's steps, in GiB, from
run_pretrain's own info["reserved_bytes"] (one reading a step, after its
dispatch), sliced as Context.window_step_s slices info["step_s"]. Unlike
peak_mem_gib (the allocated peak) it counts a CUDA graph's private pool,
whose blocks replays use without allocating. None where the program keeps
no such record."""


def read(ctx):
    reserved = ctx.info.get("reserved_bytes")
    if not reserved:
        return None
    lo = ctx.feed.warm_steps
    window = reserved[lo:lo + ctx.feed.steps]
    if not window:
        return None
    return max(window) / 2 ** 30
