"""Set-up: process start to the first timed step (imports, CUDA context,
mesh, space and structure, kernels, one warm-up step), host clock."""


def read(ctx):
    return ctx.setup_s
