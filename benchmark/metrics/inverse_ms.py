"""Mean per step of the span ``inverse``: ``a.mat.Inverse(freedofs)``,
its ``to_ell`` and SPD check (layer sparse); host clock, the device
synchronised at both ends, traced run, ms."""

SPAN = "inverse"


def read(ctx):
    d = ctx.spans.get(SPAN)
    if not d:
        return None
    return 1e3 * sum(d) / len(d)
