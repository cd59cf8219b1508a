"""The share of the traced window in which the card idled while the host
was in ``pf.ot.sinkhorn``: the dual loop of the Sinkhorn resample (its
2 × iterations half-updates, each a logsumexp over the N × N cost), in %
(idle split by overlap; ``h100_bench/spans.py``)."""

from h100_bench import spans


def read(ctx):
    return spans.idle_by_span(ctx.trace, ("pf.ot.sinkhorn",))
