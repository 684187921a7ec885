"""Fictitious-domain Poisson with normal-derivative-jump ghost penalty.

Counterpart of ``examples/fictdom_dn_ghostpen.py`` (the skeleton variant of
the reference's ``py_tutorials/fictdom_ghostpen.py:91-102``): ``dnjump``
built from the exact higher normal derivative ``dn``.

Run: ``python -m ngsxfem_tpu_torch.examples.fictdom_dn_ghostpen``.
"""
from ngsxfem_tpu_torch import *


def system(nx=20, order=1, device=None):
    """The weak forms of the workload, not yet assembled: ``(a, f, Vh,
    freedofs, l2error)`` with ``l2error(gfu)`` the L2 error of a GridFunction
    on ``Vh`` over the ring."""
    mesh = MakeStructured2DMesh(
        quads=False, nx=nx, ny=nx, mapping=lambda a, b: (2 * a - 1, 2 * b - 1)
    )
    r2c, r1c = 3 / 4, 1 / 4
    rc, rr = (r1c + r2c) / 2, (r2c - r1c) / 2
    r = sqrt(x * x + y * y)
    levelset = IfPos(r - rc, r - rc - rr, rc - r - rr)
    coeff_f = CoefficientFunction(-20 * ((r1c + r2c) / sqrt(x * x + y * y) - 4))
    exact = CoefficientFunction(20 * (r2c - sqrt(x * x + y * y)) * (sqrt(x * x + y * y) - r1c))
    h = specialcf.mesh_size

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
    lam = 10 * order * order / h

    a = BilinearForm(Vh)
    a += SymbolicBFI(lset_neg, form=grad(u) * grad(v), definedonelements=hasneg)
    a += SymbolicBFI(lset_if, form=-(grad(u) * n_lset) * v - (grad(v) * n_lset) * u
                     + lam * u * v)
    gp = 0
    for i in range(order):
        gamma = 0.1 * 0.1 ** i  # the reference's decaying per-order weights
        gp = gp + gamma * h ** (2 * i + 1) * dnjump(u, i + 1) * dnjump(v, i + 1)
    a += SymbolicBFI(form=gp, skeleton=True, definedonelements=ba_facets)

    f = LinearForm(Vh)
    f += SymbolicLFI(lset_neg, form=coeff_f * v, definedonelements=hasneg)

    def l2error(gfu):
        return Integrate(lset_neg, (gfu - exact) * (gfu - exact), mesh,
                         order=2 * order + 2) ** 0.5

    return a, f, Vh, GetDofsOfElements(Vh, hasneg), l2error


def run(nx=20, order=1, verbose=True, device=None):
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
