"""Particle-steps of every completed run over the whole window's wall time."""


def read(ctx):
    if "particle_steps" not in ctx.work or not ctx.window_s:
        return None
    return ctx.work["particle_steps"] / ctx.window_s
