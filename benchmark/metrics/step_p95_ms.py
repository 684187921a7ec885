"""95th percentile of the window's step times, host clock, ms; only with
at least 200 steps, so that ten or more lie beyond it."""
import statistics

MIN_STEPS = 200


def read(ctx):
    if len(ctx.step_s) < MIN_STEPS:
        return None
    return 1e3 * statistics.quantiles(ctx.step_s, n=100,
                                      method="inclusive")[94]
