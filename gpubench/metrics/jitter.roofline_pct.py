"""jitter.roofline_pct: the augmentation kernel's share of its memory
roofline: its launches' bytes (counts.jitter_bytes) at 3.35 TB/s over the
launches' own device time in the trace."""

from gpubench.counts import HBM_BYTES_PER_S


def read(ctx):
    w = ctx.window
    if w is None:
        return None
    seconds, launches = w.kernel("jitter_kernel")
    if not launches or seconds <= 0:
        return None
    bound = ctx.counts["jitter_bytes"] * launches / HBM_BYTES_PER_S
    return 100.0 * bound / seconds
