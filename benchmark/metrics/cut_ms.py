"""Mean per step of the span ``cut``: ``InterpolateToP1``,
``CutInfo.Update`` and the re-marking (layer geometry); host clock, the
device synchronised at both ends, traced run, ms."""

SPAN = "cut"


def read(ctx):
    d = ctx.spans.get(SPAN)
    if not d:
        return None
    return 1e3 * sum(d) / len(d)
