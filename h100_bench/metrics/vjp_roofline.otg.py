"""The Sinkhorn backward's share of its exponentials' bound, in %: the
exponentials the traced steps' backward needs at the SFU's rate, over the
union of the device intervals of the VJP kernels (``sinkhorn_vjp_kernel``).

A step's backward needs N² exponentials for each half-update's VJP (its
softmax π, recomputed) and N² for the projection's (its plan): N² × (2 ×
iterations + 1), counted from the configuration and the backward steps the
traced units need (each run's steps but its last, whose resample the
log-evidence does not read), not from the program. The bound is the H100's
SFU, 16 exponentials a clock on each of its 132 SMs at 1.98 GHz; the
kernels take every exponential there (``ex2.approx``), none on the FMA
pipe. The time is the union of the kernels' intervals, not their sum:
back-to-back launches overlap one's epilogue with the next one's start
(programmatic dependent launch), so a sum counts the overlap twice; the
union is ``h100_bench/trace.py``'s, clipped at the window's end. A
program without the kernels (the torch ops' autograd, or a tree before
them) reads nothing."""

from h100_bench import trace

SFU_EXP_PER_S = 132 * 16 * 1.98e9
KERNELS = ("sinkhorn_vjp_kernel",)


def vjp_exps(particles: int, iterations: int) -> float:
    """The exponentials one step's Sinkhorn backward needs."""
    return particles**2 * (2 * iterations + 1)


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("backward_steps"):
        return None
    tr = ctx.trace
    busy = sum(e - s for s, e in trace._union(
        [(ts, min(ts + dur, tr.t1)) for name, ts, dur in tr.device
         if any(k in name for k in KERNELS)])) * 1e-6
    if busy <= 0:
        return None
    s = ctx.shape
    exps = ctx.counts["backward_steps"] * vjp_exps(s["particles"], s["sinkhorn_iters"])
    return 100.0 * exps / SFU_EXP_PER_S / busy
