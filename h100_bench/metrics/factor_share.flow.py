"""The share of the card's busy time in Cholesky factorizations and
triangular solves (cuSOLVER and cuBLAS kernels by name), in %."""

PATTERNS = ("potrf", "trsm", "trsv", "getrf", "chol")


def read(ctx):
    if ctx.trace is None:
        return None
    total = ctx.trace.device_s()
    if total <= 0:
        return None
    factor = sum(dur for name, _, dur in ctx.trace.device
                 if any(p in name.lower() for p in PATTERNS)) * 1e-6
    return 100.0 * factor / total
