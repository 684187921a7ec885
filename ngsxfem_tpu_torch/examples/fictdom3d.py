"""3D fictitious-domain Poisson through the general forms API (the flagship
of ``models/poisson.py`` in its user-API variant): Nitsche BC on a sphere +
facet-patch ghost penalty.  Counterpart of ``examples/fictdom3d.py``.

With ``isoparametric=True`` the mesh is deformed by a 3D
LevelSetMeshAdaptation so the high-order scheme sees high-order geometry
(order k converges at k+1 instead of the P1-geometry-limited 2).  The
deformation is set on the mesh by ``system`` and unset by ``run`` after the
L2 error; a caller of ``system`` unsets it with
``Vh.mesh.UnsetDeformation()``.

Run: ``python -m ngsxfem_tpu_torch.examples.fictdom3d``.
"""
from ngsxfem_tpu_torch import *


def system(nx=8, order=1, device=None, isoparametric=False):
    """The weak forms of the workload, not yet assembled: ``(a, f, Vh,
    freedofs, l2error)`` with ``l2error(gfu)`` the L2 error of a GridFunction
    on ``Vh`` over the inside of the sphere.  With ``isoparametric`` the
    mesh (``Vh.mesh``) holds the deformation on return."""
    mesh = MakeStructured3DMesh(
        hexes=False, nx=nx, ny=nx, nz=nx,
        mapping=lambda a, b, c: (2 * a - 1, 2 * b - 1, 2 * c - 1),
    )
    R = 0.7
    r = sqrt(x * x + y * y + z * z)
    levelset = r - R
    # u = R^2 - r^2 (zero on the boundary), f = -lap u = 6
    exact = R * R - (x * x + y * y + z * z)
    coeff_f = CoefficientFunction(6.0)
    h = specialcf.mesh_size
    lam = 10 * order * order / h

    if isoparametric:
        lsa = LevelSetMeshAdaptation(mesh, order=order, threshold=0.2,
                                     discontinuous_qn=True, device=device)
        deform = lsa.CalcDeformation(levelset)
        lsetp1 = lsa.lset_p1
        mesh.SetDeformation(deform)
    else:
        lsetp1 = GridFunction(H1(mesh, order=1, device=device))
        InterpolateToP1(levelset, lsetp1)
    ci = CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(HASNEG)
    hasif = ci.GetElementsOfType(IF)
    Vh = H1(mesh, order=order, dgjumps=True, device=device)
    ba_facets = GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif)
    n_lset = 1.0 / Norm(grad(lsetp1)) * grad(lsetp1)
    u, v = Vh.TnT()

    lset_neg = {"levelset": lsetp1, "domain_type": NEG}
    lset_if = {"levelset": lsetp1, "domain_type": IF}

    a = BilinearForm(Vh)
    a += SymbolicBFI(lset_neg, form=grad(u) * grad(v), definedonelements=hasneg)
    a += SymbolicBFI(lset_if, form=-(grad(u) * n_lset) * v - (grad(v) * n_lset) * u
                     + lam * u * v)
    a += SymbolicFacetPatchBFI(
        form=0.1 / (h * h) * (u - u.Other()) * (v - v.Other()),
        definedonelements=ba_facets,
    )
    f = LinearForm(Vh)
    f += SymbolicLFI(lset_neg, form=coeff_f * v, definedonelements=hasneg)

    def l2error(gfu):
        return Integrate(lset_neg, (gfu - exact) * (gfu - exact), mesh,
                         order=2 * order + 2) ** 0.5

    return a, f, Vh, GetDofsOfElements(Vh, hasneg), l2error


def run(nx=8, order=1, verbose=True, isoparametric=False, device=None):
    a, f, Vh, freedofs, error = system(nx, order, device, isoparametric)
    try:
        a.Assemble()
        f.Assemble()
        gfu = GridFunction(Vh)
        gfu.vec.data = a.mat.Inverse(freedofs) * f.vec.data

        l2error = error(gfu)
    finally:
        Vh.mesh.UnsetDeformation()
    if verbose:
        print("L2 Error:", l2error)
    return l2error


if __name__ == "__main__":
    run()
