"""The whole filter step's share of the card's peak: the bytes every step
of the traced window needs (B1's particles and log-weights read and
written; on resample steps the weights read and the particles read and
written) at 3.35 TB/s, over the traced window's wall time, in %."""

from h100_bench import roofline


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("steps") or ctx.trace.window_s <= 0:
        return None
    n, d = ctx.shape["particles"], ctx.shape["dim"]
    need = (ctx.counts["steps"] * roofline.b1_bytes(n, d)
            + roofline.resample_bytes(ctx.counts["b2_rows"], d))
    return 100.0 * roofline.least_s(need) / ctx.trace.window_s
