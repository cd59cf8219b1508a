"""The DPF-OT step's share of the card's float32 peak: the operations that
the configured Sinkhorn work of every traced step needs, at 67 TFLOP/s,
over the traced window, in %.

A step's work is counted from the configuration and the steps completed,
not from the program's counter, so it reads the same whatever implements
it: N² cost cells × (2 × iterations + 1) passes (each half-update's
logsumexp and the plan) × 2 float32 operations a cell, one exp and one
add. No implementation can pass 100 %: 67 TFLOP/s is every SM's 128 FMA
lanes a clock, so the count gives a cell one FMA-pipe slot, and an exp
takes longer than that. The SFU issues 16 exps a clock an SM, 8 slots' time
a cell; an exp emulated on the FMA pipe (a polynomial) takes several slots
of its own, besides the add's. Whatever the split between the two, a cell
needs more than one slot."""

from h100_bench import roofline

OPS_PER_CELL = 2  # one exp and one add


def step_ops(particles: int, iterations: int) -> float:
    """The float32 operations one step's Sinkhorn resample needs."""
    return particles**2 * (2 * iterations + 1) * OPS_PER_CELL


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("steps") or ctx.trace.window_s <= 0:
        return None
    s = ctx.shape
    ops = ctx.counts["steps"] * step_ops(s["particles"], s["sinkhorn_iters"])
    return 100.0 * roofline.least_s(0.0, ops) / ctx.trace.window_s
