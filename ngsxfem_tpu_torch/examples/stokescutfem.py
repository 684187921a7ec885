"""Unfitted Stokes on a fictitious domain (CutFEM Taylor-Hood + Nitsche).

Counterpart of ``examples/stokescutfem.py`` (the reference's Stokes
workload, ``py_tutorials/stokesxfem.py``): P2/P1 velocity and pressure on
the background mesh, active dofs from CutInfo, Nitsche no-slip on the
implicit boundary, facet-patch ghost penalties for both fields, and a
manufactured divergence-free solution on a disk.  The saddle-point system is
symmetric indefinite: the default solve of ``a.mat.Inverse`` is an LU
(dense on the card where it fits, the host's otherwise); ``MinResSolver`` solves it on the device, with the
block-diagonal preconditioner of ``minres_preconditioner``.

Run: ``python -m ngsxfem_tpu_torch.examples.stokescutfem``.
"""
import torch

from ngsxfem_tpu_torch import *


def system(nx=16, order=2, device=None):
    """The weak forms of the workload, not yet assembled: ``(a, f, X,
    active, errors, pmass)`` with ``errors(gf)`` the velocity and pressure
    L2 errors of a GridFunction on ``X`` (the pressure up to its mean) and
    ``pmass`` the pressure mass form (with a ghost penalty on the cut band)
    that ``minres_preconditioner`` scales the pressure rows by."""
    R = 0.7
    mesh = MakeStructured2DMesh(
        quads=False, nx=nx, ny=nx, mapping=lambda a, b: (2 * a - 1, 2 * b - 1)
    )
    levelset = sqrt(x * x + y * y) - R
    r2 = x * x + y * y

    # u = curl((r^2-R^2)^2) (no-slip on the boundary, div-free), p = x^3+y^3
    uex = CoefficientFunction((4 * y * (r2 - R * R), -4 * x * (r2 - R * R)))
    pex = x * x * x + y * y * y
    f_cf = CoefficientFunction((-32 * y + 3 * x * x, 32 * x + 3 * y * y))

    lsetp1 = GridFunction(H1(mesh, order=1, device=device))
    InterpolateToP1(levelset, lsetp1)
    ci = CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(HASNEG)
    hasif = ci.GetElementsOfType(IF)
    ba_facets = GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif)

    V = VectorH1(mesh, order=order, dgjumps=True, device=device)
    Q = H1(mesh, order=order - 1, dgjumps=True, device=device)
    X = FESpace([V, Q])

    (u, p), (v, q) = X.TnT()
    h = specialcf.mesh_size
    n_lset = 1.0 / Norm(grad(lsetp1)) * grad(lsetp1)
    lam = 40 * order * order / h

    lset_neg = {"levelset": lsetp1, "domain_type": NEG}
    lset_if = {"levelset": lsetp1, "domain_type": IF}

    gradu, gradv = grad(u), grad(v)
    a = BilinearForm(X)
    a += SymbolicBFI(lset_neg, form=InnerProduct(gradu, gradv)
                     - div(v) * p - div(u) * q, definedonelements=hasneg)
    nitsche = (
        -((gradu * n_lset) * v) - ((gradv * n_lset) * u) + lam * (u * v)
        + p * (n_lset * v) + q * (n_lset * u)
    )
    a += SymbolicBFI(lset_if, form=nitsche)
    # ghost penalties (velocity + pressure) on the cut band
    a += SymbolicFacetPatchBFI(
        form=1.0 / (h * h) * ((u - u.Other()) * (v - v.Other())),
        definedonelements=ba_facets)
    a += SymbolicFacetPatchBFI(
        form=-0.1 * ((p - p.Other()) * (q - q.Other())),
        definedonelements=ba_facets)
    # pressure mean regularization (replaces the zero-mean constraint)
    a += SymbolicBFI(lset_neg, form=-1e-8 * p * q, definedonelements=hasneg)

    fl = LinearForm(X)
    fl += SymbolicLFI(lset_neg, form=f_cf * v, definedonelements=hasneg)

    active = CompoundBitArray(
        [GetDofsOfElements(V, hasneg), GetDofsOfElements(Q, hasneg)]
    )

    p_, q_ = Q.TnT()
    pmass = BilinearForm(Q)
    pmass += SymbolicBFI(lset_neg, form=p_ * q_, definedonelements=hasneg)
    pmass += SymbolicFacetPatchBFI(
        form=0.1 * ((p_ - p_.Other()) * (q_ - q_.Other())),
        definedonelements=ba_facets)

    def errors(gf):
        gu, gp = gf.components
        uerr2 = Integrate(lset_neg, (gu - uex) * (gu - uex), mesh,
                          order=2 * order + 2)
        area = Integrate(lset_neg, CoefficientFunction(1.0), mesh, order=2)
        pmean = Integrate(lset_neg, gp - pex, mesh, order=2 * order) / area
        perr2 = Integrate(lset_neg, (gp - pex - pmean) * (gp - pex - pmean),
                          mesh, order=2 * order)
        return uerr2**0.5, perr2**0.5

    return a, fl, X, active, errors, pmass


def minres_preconditioner(a, pmass, X, active):
    """SPD block-diagonal preconditioner for ``MinResSolver`` on the
    assembled system: the absolute diagonal of ``a`` on the velocity rows,
    the diagonal of the assembled pressure mass ``pmass`` (the
    Schur-complement scaling) on the pressure rows, identity on fixed dofs.
    The absolute diagonal of ``a`` alone scales the pressure rows by their
    1e-8 regularization and multiplies the MINRES iterations."""
    d = a.mat.diagonal().clone()
    d[X.Range(1)] = pmass.mat.diagonal()
    ad = d.abs()
    free = torch.as_tensor(active.np, device=d.device)
    dinv = torch.where(free & (ad > 1e-30), 1.0 / ad.clamp_min(1e-30), 1.0)
    return lambda r: dinv * r


def run(nx=16, order=2, verbose=True, device=None):
    a, fl, X, active, errors, _ = system(nx, order, device)
    a.Assemble()
    fl.Assemble()
    gf = GridFunction(X)
    gf.vec.data = a.mat.Inverse(active) * fl.vec.data

    uerr, perr = errors(gf)
    if verbose:
        print(f"velocity L2 error: {uerr:.6f}, pressure L2 error: {perr:.6f}")
    return uerr, perr


if __name__ == "__main__":
    run()
