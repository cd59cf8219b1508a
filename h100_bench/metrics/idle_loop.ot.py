"""The share of the traced window in which the card idled while the host
was in ``pf.ot.run`` and in none of its step's spans: the loop's own glue
(the initial cloud, the log-evidence's sum, the stacked outputs), in %
(idle split by overlap; ``h100_bench/spans.py``)."""

from h100_bench import spans


def read(ctx):
    return spans.idle_by_span(ctx.trace, ("pf.ot.run",))
