"""Host waits on the card a filter step: the synchronize calls (stream,
device, event) in the traced window over its steps. A 4-byte read such as
the resample trigger's ``.item()`` is one; the harness's sync at the end of
each run adds 1/T."""

SYNCS = ("Synchronize",)


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("steps"):
        return None
    calls = ctx.trace.runtime_calls(SYNCS)
    return calls / ctx.counts["steps"] if calls else None
