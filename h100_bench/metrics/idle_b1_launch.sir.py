"""The share of the traced window in which the card idled while the host
was in ``pf.sir.b1``: kernel B1's argument handling and Triton launch, in %
(idle split by overlap; ``h100_bench/spans.py``)."""

from h100_bench import spans


def read(ctx):
    return spans.idle_by_span(ctx.trace, ("pf.sir.b1",))
