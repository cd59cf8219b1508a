"""The share of the traced window in which the card idled while the host
was in ``pf.sir.run`` and in none of its step's spans: the run loop's own
glue (seeds, buffers, the step's Python between its spans, the history),
in % (idle split by overlap; ``h100_bench/spans.py``)."""

from h100_bench import spans


def read(ctx):
    return spans.idle_by_span(ctx.trace, ("pf.sir.run",))
