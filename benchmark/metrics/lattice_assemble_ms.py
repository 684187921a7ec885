"""Mean per step of the span ``lattice_assemble``: ``active_dof_mask``
and ``assemble_vals_lattice`` (layer lattice model); host clock, the
device synchronised at both ends, traced run, ms."""

SPAN = "lattice_assemble"


def read(ctx):
    d = ctx.spans.get(SPAN)
    if not d:
        return None
    return 1e3 * sum(d) / len(d)
