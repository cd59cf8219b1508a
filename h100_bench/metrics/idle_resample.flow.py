"""The share of the traced window in which the card idled while the host
was in ``pf.flow.trigger_read`` (the triggers and their host read) or
``pf.flow.resample`` (the triggered trials' resample by kernel B2), in %
(idle split by overlap; ``h100_bench/spans.py``)."""

from h100_bench import spans


def read(ctx):
    return spans.idle_by_span(ctx.trace, ("pf.flow.trigger_read", "pf.flow.resample"))
