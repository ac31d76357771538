"""Set-up, s: process start to the first timed call (imports, CUDA
context, the scene from the seed, the cell's warm-up and, for the fit,
the graph capture), by the host clock."""


def read(ctx):
    return ctx.setup_s
