"""Device operations per step in the profiled sub-window."""


def read(ctx):
    if not ctx.trace or not ctx.trace["n_ops"]:
        return None
    return ctx.trace["n_ops"] / ctx.trace_steps
