"""Kernel B2 (systematic resample by starts, CUDA C++): the bytes its rows
need (values read and written, a start read) at 3.35 TB/s, over the device
time of the kernels of that name, in %."""

from h100_bench import roofline

NAMES = ("merge_path_resample_kernel",)


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("b2_rows"):
        return None
    busy = ctx.trace.device_s(NAMES)
    if busy <= 0:
        return None
    need = roofline.resample_bytes(ctx.counts["b2_rows"], ctx.shape["dim"])
    return 100.0 * roofline.least_s(need) / busy
