"""Set-up: process start to the first timed call (imports, the CUDA
context, kernels loaded or built, data made on the card, the cell's own
shapes warmed), in seconds."""


def read(ctx):
    return ctx.setup_s
