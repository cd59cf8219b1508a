"""The whole flow step's share of the card's peak: the operations every
step of the traced window needs (the flow's λ-steps, by ``roofline``'s
counts for the filter kind, and the weight correction) at 67 TFLOP/s
float32, or its bytes (particles read and written each λ-step, the noise
read) at 3.35 TB/s, whichever is longer, over the traced window, in %."""

from h100_bench import roofline


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("steps") or ctx.trace.window_s <= 0:
        return None
    s, steps = ctx.shape, ctx.counts["steps"]
    rows = s["trials"] * s["particles"]
    lam = steps * s["lambda_steps"]
    if s["kind"] == "ledh":
        ops = lam * roofline.ledh_ops(rows, s["dim"])
    else:
        ops = lam * roofline.edh_ops(s["trials"], s["particles"], s["dim"])
    ops += steps * roofline.flow_weight_ops(rows, s["dim"])
    nbytes = (2 * lam + steps) * rows * s["dim"] * roofline.F32
    return 100.0 * roofline.least_s(nbytes, ops) / ctx.trace.window_s
