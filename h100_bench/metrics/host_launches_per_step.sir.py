"""Kernel and graph launches the host makes a filter step: the runtime and
driver launch calls in the traced window over its steps."""

LAUNCHES = ("LaunchKernel", "GraphLaunch", "LaunchCooperativeKernel")


def read(ctx):
    if ctx.trace is None or not ctx.counts.get("steps"):
        return None
    calls = ctx.trace.runtime_calls(LAUNCHES)
    return calls / ctx.counts["steps"] if calls else None
