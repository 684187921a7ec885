"""Share of the DIA products that ran as one launch of the hand-written
kernel, %: 100 x the program's counter ``dia_matvec::kernel`` over it and
``dia_matvec::eager`` (``sparse.dia_matvec`` adds one of the two a call,
on the path it takes), summed over the spans of the profiled sub-window of
a traced run (layer kernels).  None where the program keeps neither
counter."""

KERNEL, EAGER = "dia_matvec::kernel", "dia_matvec::eager"


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
