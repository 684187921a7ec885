"""High-order isoparametric unfitted interface problem, XFEM formulation.

Counterpart of ``examples/nxfem_higher_order.py`` (the reference tutorial
``py_tutorials/nxfem_higher_order.py``): H1 + XFESpace enrichment with
LevelSetMeshAdaptation, so the accuracy scales as O(h^{k+1}).

Run: ``python -m ngsxfem_tpu_torch.examples.nxfem_higher_order``.
"""
from ngsxfem_tpu_torch.examples import nxfem


def run(nx=15, order=3, verbose=True, device=None):
    return nxfem.run(nx=nx, order=order, verbose=verbose, deform=True,
                     device=device)


if __name__ == "__main__":
    import math

    errs = [run(nx) for nx in (8, 16)]
    print(f"eoc: {math.log(errs[0] / errs[1]) / math.log(2):.2f}")
