"""The 95th percentile of one filter run's wall time, call to sync, over
every run in the window."""

from h100_bench import harness


def read(ctx):
    if "particle_steps" not in ctx.work or not ctx.unit_s:
        return None
    return harness.percentile([t * 1e3 for t in ctx.unit_s], 95)
