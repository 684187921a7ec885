"""Time per step in the program's span ``InverseMatrix::host_lu``: the
host LU of ``Inverse()`` (the matrix copied to the host, ``to_scipy``, the
free block, ``splu``) and each triangular solve with its copies to and
from the host (layer sparse) (the program's own record,
``ngsxfem_tpu_torch.utils.timing.spans``: ``time.time_ns`` at its ends,
the card not waited for), summed over the profiled sub-window of a traced
run, over the calls of the span that the step enters once, ms.  None where
the program keeps no such record."""

SPAN = "InverseMatrix::host_lu"

# the span a forms step enters once: the solve
STEP_SPAN = "InverseMatrix::Solve"


def read(ctx):
    try:
        from ngsxfem_tpu_torch.utils.timing import spans
    except ImportError:  # a program without the span store
        return None
    recs = spans()
    steps = sum(r["name"] == STEP_SPAN for r in recs)
    d = [r["end_ns"] - r["start_ns"] for r in recs
         if r["name"] == SPAN and r["end_ns"] is not None]
    if not steps or not d:
        return None
    return 1e-6 * sum(d) / steps
