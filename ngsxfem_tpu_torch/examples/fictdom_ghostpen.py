"""Fictitious-domain Poisson with Nitsche BC + facet-patch ghost penalty.

Counterpart of ``examples/fictdom_ghostpen.py`` (the reference tutorial
``py_tutorials/fictdom_ghostpen.py``: ring domain via level set, active-mesh
pipeline CutInfo -> Compress -> ghost penalty).

Run: ``python -m ngsxfem_tpu_torch.examples.fictdom_ghostpen``.
"""
from ngsxfem_tpu_torch import *


def run(nx=40, order=1, verbose=True, gamma_stab=0.1, device=None):
    mesh = MakeStructured2DMesh(
        quads=False, nx=nx, ny=nx, mapping=lambda xx, yy: (2 * xx - 1, 2 * yy - 1)
    )
    lambda_nitsche = 10 * order * order

    r2, r1 = 3 / 4, 1 / 4
    rc, rr = (r1 + r2) / 2.0, (r2 - r1) / 2.0
    r = sqrt(x * x + y * y)
    levelset = IfPos(r - rc, r - rc - rr, rc - r - rr)

    coeff_f = CoefficientFunction(-20 * ((r1 + r2) / sqrt(x * x + y * y) - 4))
    exact = CoefficientFunction(20 * (r2 - sqrt(x * x + y * y)) * (sqrt(x * x + y * y) - r1))

    h = specialcf.mesh_size

    lsetp1 = GridFunction(H1(mesh, order=1, device=device))
    InterpolateToP1(levelset, lsetp1)

    lset_neg = {"levelset": lsetp1, "domain_type": NEG, "subdivlvl": 0}
    lset_if = {"levelset": lsetp1, "domain_type": IF, "subdivlvl": 0}

    ci = CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(HASNEG)

    Vh0 = H1(mesh, order=order, dirichlet=[], dgjumps=True, device=device)
    active_dofs = GetDofsOfElements(Vh0, hasneg)
    Vh = Compress(Vh0, active_dofs)

    gfu = GridFunction(Vh)
    hasif = ci.GetElementsOfType(IF)
    ba_facets = GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif)

    n_levelset = 1.0 / Norm(grad(lsetp1)) * grad(lsetp1)

    a = BilinearForm(Vh, symmetric=False)
    f = LinearForm(Vh)
    u, v = Vh.TrialFunction(), Vh.TestFunction()

    a += SymbolicBFI(lset_neg, form=grad(u) * grad(v), definedonelements=hasneg)
    nitsche = (
        -(grad(u) * n_levelset) * v
        - (grad(v) * n_levelset) * u
        + (lambda_nitsche / h) * u * v
    )
    a += SymbolicBFI(lset_if, form=nitsche)
    f += SymbolicLFI(lset_neg, form=coeff_f * v, definedonelements=hasneg)

    a += SymbolicFacetPatchBFI(
        form=gamma_stab / (h * h) * (u - u.Other()) * (v - v.Other()),
        skeleton=False,
        definedonelements=ba_facets,
    )

    a.Assemble()
    f.Assemble()

    gfu.vec.data = a.mat.Inverse(GetDofsOfElements(Vh, hasneg)) * f.vec.data

    l2error = Integrate(lset_neg, (gfu - exact) * (gfu - exact), mesh, order=2 * order) ** 0.5
    if verbose:
        print("L2 Error:", l2error)
    return l2error


if __name__ == "__main__":
    run()
