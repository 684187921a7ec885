"""HDG TraceFEM: a surface PDE on a circle with hybrid facet unknowns.

Counterpart of ``examples/tracefem_hdg.py`` (the reference's HDG trace-FEM
convergence test, ``tests/pytests/test_straightcutrule.py:283-430``): an L2
bulk space plus two FacetFESpaces on the cut band, element-boundary cut
integrals (codim-2 point rules at the interface crossings), a facet
stabilization driven by a facet indicator, and a RestrictedBilinearForm on
(band elements, band facets), all on the isoparametrically deformed mesh.

Problem: -Laplace_Gamma u + u = (1 + 1/R^2) x/r on the circle r=R, exact
solution u = x/r (= cos(theta) on Gamma).  ``condense=True`` eliminates the
L2 bulk block by static condensation on the host (``solvers.condense``);
otherwise ``a.mat.Inverse(freedofs)`` solves (on the card Jacobi-CG when
the free block is SPD, else the host LU).

Run: ``python -m ngsxfem_tpu_torch.examples.tracefem_hdg``.
"""
import numpy as np

from ngsxfem_tpu_torch import *
from ngsxfem_tpu_torch.fem.facetspace import FacetFESpace
from ngsxfem_tpu_torch.fem.hdiv import HDiv


def system(nx=16, order=1, R=0.7, device=None):
    """The unassembled HDG system: a dict with the mesh, its deformation,
    the spaces, the forms ``a``/``f``, ``freedofs``, the IF domain and the
    exact solution."""
    mesh = MakeStructured2DMesh(
        quads=False, nx=nx, ny=nx, mapping=lambda a, b: (2 * a - 1, 2 * b - 1))

    r = sqrt(x * x + y * y)
    levelset = r - R
    lsetmeshadap = LevelSetMeshAdaptation(mesh, order=order, threshold=10.25,
                                          device=device)
    deformation = lsetmeshadap.CalcDeformation(levelset)
    lsetp1 = lsetmeshadap.lset_p1

    exact = x / r
    f_coeff = (1 + 1 / (x * x + y * y)) * x / r

    ci = CutInfo(mesh, lsetp1)
    reg_Th = ci.GetElementsOfType(IF)
    reg_Fh = GetFacetsWithNeighborTypes(mesh, a=reg_Th, b=reg_Th, use_and=True)
    cf_reg_Fh = IndicatorCF(mesh, reg_Fh, facets=True)

    fes1 = L2(mesh, order=order, device=device)
    fes2 = FacetFESpace(mesh, order=order, device=device)
    fes3 = FacetFESpace(mesh, order=max(order - 1, 0), device=device)
    Vhg = FESpace([fes1, fes2, fes3], dgjumps=True)

    def Normalized(u):
        return 1.0 / Norm(u) * u

    n_phi = Normalized(grad(lsetp1))

    def P(u):
        return u - (u * n_phi) * n_phi

    h = specialcf.mesh_size
    n_F = specialcf.normal(2)
    conormal = Normalized(P(n_F))

    # side-consistent facet normal: project a fixed HDiv order-0 field onto
    # the facet normal and renormalize (the reference's normal_helper trick)
    nh_gf = GridFunction(HDiv(mesh, order=0, device=device))
    nh_gf.vec.data = nh_gf.vec.data * 0 + 1.0
    normal_helper = Normalized(InnerProduct(nh_gf, n_F) * n_F)

    beta_E = 4 * (order + 1) ** 2
    beta_F = 100.0
    beta_F2 = 1.0
    lam_nd = 0.0 if order == 1 else 0.1 / h + 0.1 * h

    (u, uhat, sigmahat) = Vhg.TrialFunction()
    (v, vhat, tauhat) = Vhg.TestFunction()
    lset_if = {"levelset": lsetp1, "domain_type": IF, "subdivlvl": 0}

    def jump(w, what):
        return w - what

    a = RestrictedBilinearForm(Vhg, "a", reg_Th, reg_Fh, check_unused=False)
    a += SymbolicBFI(lset_if, form=P(grad(u)) * P(grad(v)) + u * v,
                     definedonelements=reg_Th)
    if order > 1:
        a += SymbolicBFI(form=(lam_nd * (grad(u) * n_phi)) * (grad(v) * n_phi),
                         definedonelements=reg_Th)
    a += SymbolicBFI(
        lset_if,
        form=(-InnerProduct(grad(u), conormal) * jump(v, vhat)
              - InnerProduct(grad(v), conormal) * jump(u, uhat)
              + beta_E / h * jump(u, uhat) * jump(v, vhat)) * cf_reg_Fh,
        element_boundary=True, definedonelements=reg_Th)
    a += SymbolicBFI(form=beta_F / (h * h) * jump(u, uhat) * jump(v, vhat)
                     * cf_reg_Fh,
                     element_boundary=True, definedonelements=reg_Th)
    a += SymbolicBFI(form=beta_F2 * (grad(u) * normal_helper - sigmahat)
                     * (grad(v) * normal_helper - tauhat) * cf_reg_Fh,
                     element_boundary=True, definedonelements=reg_Th)

    f = LinearForm(Vhg)
    f += SymbolicLFI(lset_if, form=f_coeff * v, definedonelements=reg_Th)

    freedofs = CompoundBitArray([
        GetDofsOfElements(fes1, reg_Th),
        GetDofsOfFacets(fes2, reg_Fh),
        GetDofsOfFacets(fes3, reg_Fh),
    ])
    return {"mesh": mesh, "deformation": deformation, "Vhg": Vhg,
            "fes1": fes1, "a": a, "f": f, "freedofs": freedofs,
            "lset_if": lset_if, "exact": exact}


def error(sys_, gfu, order):
    """L2(Gamma) error of the bulk component (on the deformed mesh)."""
    uh = gfu.components[0]
    return Integrate(sys_["lset_if"], cf=(uh - sys_["exact"]) ** 2,
                     mesh=sys_["mesh"], order=2 * order + 2) ** 0.5


def run(nx=16, order=1, R=0.7, verbose=True, condense=False, device=None):
    s = system(nx, order, R, device)
    mesh, a, f = s["mesh"], s["a"], s["f"]
    mesh.SetDeformation(s["deformation"])
    try:
        a.Assemble()
        f.Assemble()
        gfu = GridFunction(s["Vhg"])
        if condense:
            # eliminate the L2 bulk block (the reference's
            # eliminate_internal flag) by static condensation
            from ngsxfem_tpu_torch.solvers.condense import condensed_solve

            local = np.zeros(s["Vhg"].ndof, dtype=bool)
            local[:s["fes1"].ndof] = True
            gfu.vec.data = condensed_solve(a.mat, f.vec.data, local,
                                           freedofs=s["freedofs"])
        else:
            gfu.vec.data = a.mat.Inverse(s["freedofs"]) * f.vec.data
        l2err = error(s, gfu, order)
    finally:
        mesh.UnsetDeformation()
    if verbose:
        print(f"tracefem_hdg nx={nx} order={order}: L2(Gamma) err={l2err:.3e}")
    return l2err


if __name__ == "__main__":
    import math

    for order in (1, 2):
        errs = [run(nx, order=order) for nx in (8, 16, 32)]
        eocs = [math.log(errs[i] / errs[i + 1]) / math.log(2)
                for i in range(len(errs) - 1)]
        print(f"order {order}: eocs {['%.2f' % e for e in eocs]}")
