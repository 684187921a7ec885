"""API demo: unfitted FE space features.

Counterpart of ``examples/xfespaces.py`` (the reference tutorial
``py_tutorials/xfespaces.py``): CutInfo queries, XFESpace dof bookkeeping,
enrichment operators, the cut-ratio CF, and compressed spaces.

Run: ``python -m ngsxfem_tpu_torch.examples.xfespaces``.
"""
import numpy as np

from ngsxfem_tpu_torch import *


def system(device=None):
    """The demo's numbers: element counts per domain type, the mean cut
    ratio on IF elements, the base, enrichment and compressed ndof and the
    integrals of neg(u_x) over NEG and pos(u_x) over POS for u_x = 1."""
    mesh = MakeStructured2DMesh(quads=False, nx=10, ny=10)
    levelset = sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2) - 0.3
    lsetp1 = GridFunction(H1(mesh, order=1, device=device))
    InterpolateToP1(levelset, lsetp1)

    ci = CutInfo(mesh, lsetp1)
    out = {f"elements {getattr(dom, 'name', dom)}":
           ci.GetElementsOfType(dom).NumSet()
           for dom in [NEG, POS, IF, HASNEG, HASPOS, ANY]}
    out["mean cut ratio on IF"] = float(
        np.mean(ci.GetCutRatios()[ci.GetElementsOfType(IF).np]))

    Vh = H1(mesh, order=2, device=device)
    Vhx = XFESpace(Vh, lsetp1)
    out["base ndof"], out["enrichment ndof"] = Vh.ndof, Vhx.ndof

    gfx = GridFunction(Vhx)
    gfx.vec = np.ones(Vhx.ndof)
    # neg/pos parts and two-field conversion
    gf2 = GridFunction(FESpace([Vh, Vh]))
    XToNegPos(gfx, gf2)
    out["int_NEG neg(u_x)"] = Integrate(
        {"levelset": lsetp1, "domain_type": NEG}, neg(gfx), mesh, order=2)
    out["int_POS pos(u_x)"] = Integrate(
        {"levelset": lsetp1, "domain_type": POS}, pos(gfx), mesh, order=2)
    out["XToNegPos sums"] = (float(gf2.components[0].vec.NumPy().sum()),
                             float(gf2.components[1].vec.NumPy().sum()))

    # compressed space on the active band
    act = GetDofsOfElements(Vh, ci.GetElementsOfType(HASNEG))
    out["compressed ndof"] = Compress(Vh, act).ndof
    return out


def run(verbose=True, device=None):
    out = system(device)
    if verbose:
        for k, val in out.items():
            print(f"{k}: {val}")
    return out["enrichment ndof"], out["compressed ndof"]


if __name__ == "__main__":
    run()
