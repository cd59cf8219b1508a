"""The share of the traced window in which the card idled while the host
was in ``pf.ledh.factors``: the vmapped per-particle factors of one LEDH
λ-step (the Jacobians, W, the stacked Cholesky, uⁱ and the log-dets), in %
(idle split by overlap; ``h100_bench/spans.py``)."""

from h100_bench import spans


def read(ctx):
    return spans.idle_by_span(ctx.trace, ("pf.ledh.factors",))
