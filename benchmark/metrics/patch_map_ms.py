"""Mean per call of the program's span ``FacetPatch::map``: the facet-patch
ghost penalty's map of each neighbour's quadrature points into the other
element, Newton steps on the deformed map under a deformation (layer
forms) (the program's own record, ``ngsxfem_tpu_torch.utils.timing.spans``:
``time.time_ns`` at its ends, the card not waited for), over the profiled
sub-window of a traced run, ms.  None where the program keeps no such
record."""

SPAN = "FacetPatch::map"


def read(ctx):
    try:
        from ngsxfem_tpu_torch.utils.timing import spans
    except ImportError:  # a program without the span store
        return None
    d = [r["end_ns"] - r["start_ns"] for r in spans()
         if r["name"] == SPAN and r["end_ns"] is not None]
    if not d:
        return None
    return 1e-6 * sum(d) / len(d)
