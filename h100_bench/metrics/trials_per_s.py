"""Trials of every completed batch over the whole window's wall time."""


def read(ctx):
    if "trials" not in ctx.work or not ctx.window_s:
        return None
    return ctx.work["trials"] / ctx.window_s
