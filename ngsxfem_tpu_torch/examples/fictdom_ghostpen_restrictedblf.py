"""Fictitious-domain Poisson, higher order, dn-jump ghost penalty on a
RestrictedBilinearForm.

Counterpart of ``examples/fictdom_ghostpen_restrictedblf.py`` (the reference
tutorial ``py_tutorials/fictdom_ghostpen_restrictedblf.py``): order-3
discretization with the isoparametric level-set deformation, skeleton
dn-jump ghost penalty, and a bilinear form restricted to the active elements
and stabilization facets (the tutorial prints the padded ELL size of the
full vs the restricted operator).

Run: ``python -m ngsxfem_tpu_torch.examples.fictdom_ghostpen_restrictedblf``.
"""
from ngsxfem_tpu_torch import *


def run(nx=20, order=3, verbose=True, device=None):
    mesh = MakeStructured2DMesh(
        quads=False, nx=nx, ny=nx, mapping=lambda a, b: (2 * a - 1, 2 * b - 1)
    )
    gamma_stab = [0.1, 0.01, 0.001, 0.0001, 0.00001, 0.00001]
    lambda_nitsche = 10 * order * order

    r2c, r1c = 3 / 4, 1 / 4
    rc, rr = (r1c + r2c) / 2.0, (r2c - r1c) / 2.0
    r = sqrt(x * x + y * y)
    levelset = IfPos(r - rc, r - rc - rr, rc - r - rr)
    coeff_f = CoefficientFunction(-20 * ((r1c + r2c) / sqrt(x * x + y * y) - 4))
    exact = CoefficientFunction(
        20 * (r2c - sqrt(x * x + y * y)) * (sqrt(x * x + y * y) - r1c))
    h = specialcf.mesh_size

    lsetmeshadap = LevelSetMeshAdaptation(mesh, order=order, threshold=0.1,
                                          device=device)
    deformation = lsetmeshadap.CalcDeformation(levelset)
    lsetp1 = lsetmeshadap.lset_p1

    lset_neg = {"levelset": lsetp1, "domain_type": NEG, "subdivlvl": 0}
    lset_if = {"levelset": lsetp1, "domain_type": IF, "subdivlvl": 0}

    ci = CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(HASNEG)
    hasif = ci.GetElementsOfType(IF)

    Vh = H1(mesh, order=order, dirichlet=[], dgjumps=True, device=device)
    active_dofs = GetDofsOfElements(Vh, hasneg)

    ba_facets = GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif)
    n_levelset = 1.0 / Norm(grad(lsetp1)) * grad(lsetp1)

    u, v = Vh.TrialFunction(), Vh.TestFunction()

    # full vs restricted sparsity: the full dgjumps pattern couples every
    # interior-facet neighbour pair, the restricted form only the active
    # elements and the stabilization facets
    a_full = BilinearForm(Vh, symmetric=False)
    a_full += SymbolicBFI(form=u * v)
    a_full += SymbolicBFI(form=(u - u.Other()) * (v - v.Other()), skeleton=True)
    a_full.Assemble()
    nnz_full = a_full.mat.ell().vals.numel()

    a = RestrictedBilinearForm(Vh, "test", hasneg, ba_facets)
    a += SymbolicBFI(lset_neg, form=grad(u) * grad(v), definedonelements=hasneg)
    nitsche = (
        -(grad(u) * n_levelset) * v
        - (grad(v) * n_levelset) * u
        + (lambda_nitsche / h) * u * v
    )
    a += SymbolicBFI(lset_if, form=nitsche, definedonelements=hasif)

    gp = 0
    for i in range(order):
        gamma = gamma_stab[min(i, len(gamma_stab) - 1)]
        gp = gp + gamma * h ** (2 * i + 1) * dnjump(u, i + 1) * dnjump(v, i + 1)
    a += SymbolicBFI(form=gp, skeleton=True, definedonelements=ba_facets)

    f = LinearForm(Vh)
    f += SymbolicLFI(lset_neg, form=coeff_f * v, definedonelements=hasneg)

    mesh.SetDeformation(deformation)
    try:
        a.Assemble()
        f.Assemble()

        gfu = GridFunction(Vh)
        gfu.vec.data = a.mat.Inverse(active_dofs) * f.vec.data

        l2error = Integrate(lset_neg, (gfu - exact) * (gfu - exact), mesh,
                            order=2 * order) ** 0.5
    finally:
        mesh.UnsetDeformation()
    nnz_restr = a.mat.ell().vals.numel()
    if verbose:
        print("nnz full:", int(nnz_full), "restricted:", int(nnz_restr))
        print("L2 Error:", l2error)
    return l2error, int(nnz_full), int(nnz_restr)


if __name__ == "__main__":
    run()
