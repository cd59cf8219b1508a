"""The share of the traced window in which the card idled while the host
was in ``pf.ot.step`` and in neither of the resample's spans (propagation,
weights, the evidence's increment, the cost matrix) or in ``pf.ot.project``
(the transport plan and the barycentric projection), in % (idle split by
overlap; ``h100_bench/spans.py``)."""

from h100_bench import spans


def read(ctx):
    return spans.idle_by_span(ctx.trace, ("pf.ot.step", "pf.ot.project"))
