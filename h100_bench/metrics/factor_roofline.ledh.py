"""LEDH's per-particle factorizations' share of their float32 roofline, in
%: the operations the traced units' factored matrices need, d³/3 each
(``LEDHFlowPF.factored_matrices`` of them: the two SPD matrices a particle
and λ-step of the Woodbury flow), at 67 TFLOP/s float32, over the union of
the device intervals of the Cholesky kernels (cuSOLVER's batched POTRF
runs four, ``potrf_cta_lower_batch``, ``potrfBatch_trsm_lower`` and the two
``potrf_syrk_*``: their names hold ``potrf``), clipped at the window's end.
The count lives here, from the counter and the configuration's d, whatever
implements the factorization. The time also holds the step's other
factorizations of batch B (the tracker's, P's and the condition number's),
whose operations are not counted: on an H100 they take 2.7 % of the
``potrf`` time at d = 400 and 1.7 % at d = 144, so the share reads that
much low. A program without the counter reads nothing."""

from h100_bench import roofline, trace

KERNELS = ("potrf",)


def factor_ops(d: int) -> float:
    """The operations one Cholesky factorization of a d×d matrix needs."""
    return d**3 / 3


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("factored_matrices"):
        return None
    tr = ctx.trace
    busy = sum(e - s for s, e in trace._union(
        [(ts, min(ts + dur, tr.t1)) for name, ts, dur in tr.device
         if any(k in name.lower() for k in KERNELS)])) * 1e-6
    if busy <= 0:
        return None
    ops = ctx.counts["factored_matrices"] * factor_ops(ctx.shape["dim"])
    return 100.0 * ops / roofline.FP32_OPS_PER_S / busy
