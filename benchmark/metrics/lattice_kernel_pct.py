"""Share of the lattice assemblies that ran as one launch of the
hand-written kernel, %: 100 x the program's counter
``UnfittedPoisson::assemble_vals_lattice::kernel`` over it and
``UnfittedPoisson::assemble_vals_lattice::eager``
(``UnfittedPoisson.assemble_vals_lattice`` adds one of the two a call, on
the path it takes), summed over the spans of the profiled sub-window of a
traced run (layer lattice model).  None where the program keeps neither
counter."""

KERNEL = "UnfittedPoisson::assemble_vals_lattice::kernel"
EAGER = "UnfittedPoisson::assemble_vals_lattice::eager"


def read(ctx):
    try:
        from ngsxfem_tpu_torch.utils.timing import spans
    except ImportError:  # a program without the span store
        return None
    recs = spans()
    kernel = sum(r["counters"].get(KERNEL, 0) for r in recs)
    eager = sum(r["counters"].get(EAGER, 0) for r in recs)
    if not kernel + eager:
        return None
    return 100.0 * kernel / (kernel + eager)
