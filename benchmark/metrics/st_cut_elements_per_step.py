"""Elements taken through the space-time cut rule per step: the program's
counter ``SpaceTimeCutRule::elements`` summed over the spans of the
profiled sub-window of a traced run, over the calls of the span that the
step enters once (layer geometry).  None where the program keeps no such
record."""

COUNTER = "SpaceTimeCutRule::elements"

# the span a forms step enters once: the solve
STEP_SPAN = "InverseMatrix::Solve"


def read(ctx):
    try:
        from ngsxfem_tpu_torch.utils.timing import spans
    except ImportError:  # a program without the span store
        return None
    recs = spans()
    steps = sum(r["name"] == STEP_SPAN for r in recs)
    total = sum(r["counters"].get(COUNTER, 0) for r in recs)
    if not steps or not total:
        return None
    return total / steps
