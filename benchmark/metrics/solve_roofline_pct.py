"""Share of its roofline that the solve reaches, %.

The least time for the work that the solve's inputs need (the products
and CG iterations each profiled step's driver reports, counted by
``harness.peaks.solve_least_s`` from the operator's real slots, never from
a kernel or a layout) over the device-busy time of the operations inside
the ``solve`` spans of the profiled sub-window.
"""
from harness.peaks import solve_least_s


def read(ctx):
    if not ctx.trace or not ctx.work:
        return None
    busy = ctx.trace["span_busy"].get("solve", 0.0)
    least = sum(solve_least_s(w["solve"]["products"],
                              w["solve"]["iterations"])[0] for w in ctx.work)
    if busy <= 0 or least <= 0:
        return None
    return 100.0 * least / busy
