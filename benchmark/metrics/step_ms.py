"""Window time over the steps completed in it, host clock, ms."""


def read(ctx):
    if not ctx.step_s:
        return None
    return 1e3 * ctx.window_s / len(ctx.step_s)
