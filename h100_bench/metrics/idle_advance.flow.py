"""The share of the traced window in which the card idled while the host
was in ``pf.flow.advance``: the vmapped step over trials (tracker,
propagation, the flow's λ-steps, the weight correction), in % (idle split
by overlap; ``h100_bench/spans.py``)."""

from h100_bench import spans


def read(ctx):
    return spans.idle_by_span(ctx.trace, ("pf.flow.advance",))
