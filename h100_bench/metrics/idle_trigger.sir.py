"""The share of the traced window in which the card idled while the host
was in ``pf.sir.trigger_read``: the step's 4-byte read of the resample
trigger, in % (idle split by overlap; ``h100_bench/spans.py``)."""

from h100_bench import spans


def read(ctx):
    return spans.idle_by_span(ctx.trace, ("pf.sir.trigger_read",))
