"""Host reads of device values per step inside the program's spans: the
program's counter ``host_syncs`` (each synchronising CUDA call while a span
is open: ``bool``/``float``/``.item()`` of a card tensor, copies to the
host, ``nonzero`` and boolean-mask indexing, pageable copies to the card,
explicit synchronises) summed over the spans of the profiled sub-window
of a traced run, over the calls of the span that the step enters once
(layer device).  None where the program keeps no such record."""

COUNTER = "host_syncs"

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
