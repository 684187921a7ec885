"""DG fictitious-domain Poisson with Nitsche BC, interior penalty and
facet-patch ghost penalty.

Counterpart of ``examples/fictdom_dg_ghostpen.py`` (the reference tutorial
``py_tutorials/fictdom_dg_ghostpen.py``): an L2 (DG) space compressed to the
active mesh, cut-facet interior-penalty skeleton integrals, facet-patch
ghost penalty across the interface band, and a RestrictedBilinearForm with
element and facet restrictions.

Run: ``python -m ngsxfem_tpu_torch.examples.fictdom_dg_ghostpen``.
"""
from ngsxfem_tpu_torch import *


def system(nx=40, order=2, device=None):
    """The weak forms of the workload, not yet assembled: ``(a, f, Vh,
    freedofs, l2error)`` with ``l2error(gfu)`` the L2 error of a GridFunction
    on ``Vh`` over the ring."""
    mesh = MakeStructured2DMesh(
        quads=False, nx=nx, ny=nx, mapping=lambda xx, yy: (2 * xx - 1, 2 * yy - 1)
    )
    lambda_nitsche = 10 * order * order
    lambda_dg = 10 * order * order

    r2, r1 = 3 / 4, 1 / 4
    rc, rr = (r1 + r2) / 2.0, (r2 - r1) / 2.0
    r = sqrt(x * x + y * y)
    levelset = IfPos(r - rc, r - rc - rr, rc - r - rr)

    coeff_f = CoefficientFunction(-20 * ((r1 + r2) / sqrt(x * x + y * y) - 4))
    exact = CoefficientFunction(
        20 * (r2 - sqrt(x * x + y * y)) * (sqrt(x * x + y * y) - r1))

    h = specialcf.mesh_size

    lsetp1 = GridFunction(H1(mesh, order=1, device=device))
    InterpolateToP1(levelset, lsetp1)
    lset_neg = {"levelset": lsetp1, "domain_type": NEG, "subdivlvl": 0}
    lset_if = {"levelset": lsetp1, "domain_type": IF, "subdivlvl": 0}

    ci = CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(HASNEG)
    hasif = ci.GetElementsOfType(IF)
    ba_gp_facets = GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif,
                                              use_and=True)
    ba_fd_facets = GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasneg,
                                              use_and=True)

    Vh0 = L2(mesh, order=order, dgjumps=True, device=device)
    Vh = Compress(Vh0, GetDofsOfElements(Vh0, hasneg))

    n_levelset = 1.0 / Norm(grad(lsetp1)) * grad(lsetp1)
    nF = specialcf.normal(mesh.dim)

    a = RestrictedBilinearForm(Vh, "a", element_restriction=hasneg,
                               facet_restriction=ba_fd_facets,
                               check_unused=False)
    f = LinearForm(Vh)
    u, v = Vh.TrialFunction(), Vh.TestFunction()

    # diffusion
    a += SymbolicBFI(lset_neg, form=grad(u) * grad(v), definedonelements=hasneg)
    # ghost penalty (volumetric facet patches on the interface band)
    a += SymbolicFacetPatchBFI(
        form=0.1 / (h * h) * (u - u.Other()) * (v - v.Other()),
        skeleton=False, definedonelements=ba_gp_facets)

    # interior penalty on cut facets of the active mesh
    flux_u = -0.5 * (grad(u) + grad(u.Other())) * nF
    flux_v = -0.5 * (grad(v) + grad(v.Other())) * nF
    jump_u = u - u.Other()
    jump_v = v - v.Other()
    a += SymbolicBFI(
        lset_neg,
        form=lambda_dg / h * jump_u * jump_v + flux_u * jump_v + flux_v * jump_u,
        skeleton=True, definedonelements=ba_fd_facets)

    # Nitsche on the interface
    nitsche = (-(grad(u) * n_levelset) * v - (grad(v) * n_levelset) * u
               + (lambda_nitsche / h) * u * v)
    a += SymbolicBFI(lset_if, form=nitsche, definedonelements=hasif)

    f += SymbolicLFI(lset_neg, form=coeff_f * v, definedonelements=hasneg)

    def l2error(gfu):
        return Integrate(lset_neg, (gfu - exact) * (gfu - exact), mesh,
                         order=2 * order) ** 0.5

    return a, f, Vh, GetDofsOfElements(Vh, hasneg), l2error


def run(nx=40, order=2, verbose=True, device=None):
    a, f, Vh, freedofs, error = system(nx, order, device)
    a.Assemble()
    f.Assemble()
    gfu = GridFunction(Vh)
    gfu.vec.data = a.mat.Inverse(freedofs) * f.vec.data

    l2error = error(gfu)
    if verbose:
        print("L2 Error:", l2error)
    return l2error


if __name__ == "__main__":
    run()
