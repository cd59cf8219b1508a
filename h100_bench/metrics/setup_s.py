"""Set-up: the process's start to the first timed unit (imports, the CUDA
context, the kernels' builds or cache loads, the data, the warm-up)."""


def read(ctx):
    return ctx.setup_s
