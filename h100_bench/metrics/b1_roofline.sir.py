"""Kernel B1 (the fused propagate-and-weight step, Triton): the bytes its
launches need (particles and log-weights read and written) at 3.35 TB/s,
over the device time of the kernels of that name, in %."""

from h100_bench import roofline

NAMES = ("_fused_step_kernel",)


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("b1_launches"):
        return None
    busy = ctx.trace.device_s(NAMES)
    if busy <= 0:
        return None
    need = ctx.counts["b1_launches"] * roofline.b1_bytes(ctx.shape["particles"],
                                                          ctx.shape["dim"])
    return 100.0 * roofline.least_s(need) / busy
