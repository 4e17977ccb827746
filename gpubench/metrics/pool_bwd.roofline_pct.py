"""pool_bwd.roofline_pct: the max-pool backward's share of its memory
roofline over the traced steps: the bytes of every pool of the query
encoder's backward (counts.pool_launches, counts.pool_bwd_bytes) at
3.35 TB/s over the summed device time of the pool1d_bwd kernel's
launches."""

from gpubench.counts import HBM_BYTES_PER_S


def read(ctx):
    w = ctx.window
    if w is None:
        return None
    seconds, launches = w.kernel("pool1d_bwd_kernel")
    if not launches or seconds <= 0:
        return None
    bound = ctx.counts["pool_bytes"] * w.steps
    return 100.0 * bound / HBM_BYTES_PER_S / seconds
