"""Mean per step of the span ``solve``: ``inv * f.vec`` or ``cg_ir``
(layer krylov); host clock, the device synchronised at both ends, traced
run, ms."""

SPAN = "solve"


def read(ctx):
    d = ctx.spans.get(SPAN)
    if not d:
        return None
    return 1e3 * sum(d) / len(d)
