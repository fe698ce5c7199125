"""From the start of the benchmark's process to its first timed call:
starting the destination (imports, the CUDA context, the kernels' build on
a checkout's first run), drawing the weights, connecting, and warming up
every prompt length of the mix, s."""


def read(ctx):
    return ctx.setup_s
