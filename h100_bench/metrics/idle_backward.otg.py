"""The share of the traced window in which the card idled while the host
was in ``pf.ot.vjp``: the Sinkhorn resample's backward (its one library
call of 4 × iterations + 2 launches), which runs on autograd's device
thread, between the caller's ``pf.ot.run`` spans, in % (idle split by
overlap; ``h100_bench/spans.py``). A program without the span reads
nothing."""

from h100_bench import spans


def read(ctx):
    return spans.idle_by_span(ctx.trace, ("pf.ot.vjp",))
