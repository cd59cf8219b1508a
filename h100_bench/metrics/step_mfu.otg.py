"""The DPF-OT value-and-gradient step's share of the card's float32 peak:
the operations that the configured Sinkhorn work of every traced step
needs, forward and backward, at 67 TFLOP/s, over the traced window, in %.

``step_mfu.ot``'s count (its ``step_ops``: N² cells × (2 × iterations + 1)
passes × one exp and one add) for every step, and again for every backward
step (each run's steps but its last, whose resample the log-evidence does
not read): the backward's least work is the same cells once more, each
half-update's softmax and the plan recomputed with one exp and one add a
cell. Counted from the configuration and the units, whatever implements
them; as for ``step_mfu.ot``, no implementation can pass 100 %."""

from h100_bench import harness, roofline


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("steps") or ctx.trace.window_s <= 0:
        return None
    s = ctx.shape
    step_ops = harness.load_module("metrics", "step_mfu.ot").step_ops
    steps = ctx.counts["steps"] + ctx.counts.get("backward_steps", 0)
    ops = steps * step_ops(s["particles"], s["sinkhorn_iters"])
    return 100.0 * roofline.least_s(0.0, ops) / ctx.trace.window_s
