"""Conjugate-gradient iterations per step: the program's counter
``cg::iterations`` (``krylov.cg`` adds its k once per call: the
``Inverse`` solve's Jacobi-CG, ``cg_ir``'s inner solves, the lattice
configuration's float64 fallback) summed over the spans of the profiled
sub-window of a traced run, over the calls of the span that the step
enters once (layer krylov).  None where the program keeps no such
record."""

COUNTER = "cg::iterations"

# the span each cell's step enters once: the forms cells' solve, the
# lattice cell's refinement; a step is one call of the first of these that
# the store holds
STEP_SPANS = ("InverseMatrix::Solve", "cg_ir")


def read(ctx):
    try:
        from ngsxfem_tpu_torch.utils.timing import spans
    except ImportError:  # a program without the span store
        return None
    recs = spans()
    for step in STEP_SPANS:
        steps = sum(r["name"] == step for r in recs)
        if steps:
            return sum(r["counters"].get(COUNTER, 0) for r in recs) / steps
    return None
