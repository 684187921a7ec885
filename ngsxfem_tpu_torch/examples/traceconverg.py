"""TraceFEM convergence study on a 2D interface (circle).

Counterpart of ``examples/traceconverg.py`` (the reference tutorial
``py_tutorials/traceconverg.py``): the surface-PDE discretization lives in
``examples/tracefem.py``; this driver runs its EOC study and prints the
convergence table.

Run: ``python -m ngsxfem_tpu_torch.examples.traceconverg``.
"""
from ngsxfem_tpu_torch.examples.tracefem import converg


def run(orders=(1, 2), levels=3, verbose=True, device=None):
    """{order: (errors, eocs)} of the EOC study of each order."""
    out = {}
    for order in orders:
        errs, eocs = converg(order=order, levels=levels, verbose=False,
                             device=device)
        out[order] = (errs, eocs)
        if verbose:
            print(f"order {order}: errors {['%.3e' % e for e in errs]} "
                  f"eocs {['%.2f' % e for e in eocs]}")
    return out


if __name__ == "__main__":
    run()
