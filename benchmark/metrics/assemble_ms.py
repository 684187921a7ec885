"""Mean per step of the span ``assemble``: every ``Assemble`` call of a
step with the forms' construction (layer forms); host clock, the device
synchronised at both ends, traced run, ms."""

SPAN = "assemble"


def read(ctx):
    d = ctx.spans.get(SPAN)
    if not d:
        return None
    return 1e3 * sum(d) / len(d)
