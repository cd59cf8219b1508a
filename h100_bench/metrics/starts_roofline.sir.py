"""Kernel S (the systematic resample's starts from the weights, CUDA C++):
the bytes its rows need (one f32 weight read and one int32 start written a
row) at 3.35 TB/s, over the device time of the kernels whose name holds
``systematic_starts``, in %. The bytes are the least the work needs, so the
share cannot pass 100 % whatever computes the starts. None where no such
kernel ran (a program that computes the starts otherwise)."""

from h100_bench import roofline

NAMES = ("systematic_starts",)
ROW_BYTES = 2 * roofline.F32  # a weight read, a start written


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("b2_rows"):
        return None
    busy = ctx.trace.device_s(NAMES)
    if busy <= 0:
        return None
    return 100.0 * roofline.least_s(ROW_BYTES * ctx.counts["b2_rows"]) / busy
