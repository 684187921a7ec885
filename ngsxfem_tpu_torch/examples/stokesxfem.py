"""Unfitted Stokes interface problem, XFEM (enrichment) formulation.

Counterpart of ``examples/stokesxfem.py`` (the reference tutorial
``py_tutorials/stokesxfem.py``): P2X/P1X Taylor-Hood with XFESpace
enrichment per velocity component and pressure, Hansbo-averaged Nitsche
interface coupling, surface-tension pressure jump, zero-mean pressure via a
NumberSpace Lagrange multiplier, and pressure ghost penalty on the cut band
(facet-patch form of the reference's dn-jump skeleton stabilization), with
the isoparametric deformation under ``deform=True``.  Manufactured solution
from Kirchhart/Gross/Reusken (SISC 2016).  The system is symmetric
indefinite: the default solve is the host LU of ``a.mat.Inverse``;
``solver="minres"`` runs ``MinResSolver`` on the device.

Run: ``python -m ngsxfem_tpu_torch.examples.stokesxfem``.
"""
import torch

from ngsxfem_tpu_torch import *


def run(nx=16, order=2, verbose=True, deform=False, solver="direct",
        device=None):
    mesh = MakeStructured2DMesh(
        quads=False, nx=nx, ny=nx, mapping=lambda a, b: (2 * a - 1, 2 * b - 1)
    )

    mu1, mu2 = 1.0, 10.0
    mu = [mu1, mu2]
    R = 2.0 / 3.0
    aneg = 1.0 / mu1
    apos = 1.0 / mu2 + (1.0 / mu1 - 1.0 / mu2) * exp(x * x + y * y - R * R)
    gammaf = 0.5  # surface tension = pressure jump

    levelset = sqrt(x * x + y * y) - R
    ee = exp(-1 * (x * x + y * y))
    src = CoefficientFunction((
        ee * ((-8 * y) + (4 * x * x * y) + (4 * y * y * y)) + 3 * x * x,
        ee * ((-4 * x * x * x) + (8 * x) - (4 * x * y * y)),
    ))
    vel_neg_ex = CoefficientFunction((aneg * ee * (-1.0) * y, aneg * ee * x))
    vel_pos_ex = CoefficientFunction((apos * ee * (-1.0) * y, apos * ee * x))
    p_neg_ex = x * x * x
    p_pos_ex = x * x * x - gammaf

    gamma_stab = 0.05
    lam = 0.5 * (mu1 + mu2) * 20 * order * order

    deformation = None
    if deform:
        lsetadap = LevelSetMeshAdaptation(mesh, order=order, threshold=10.5,
                                          device=device)
        deformation = lsetadap.CalcDeformation(levelset)
        lsetp1 = lsetadap.lset_p1
    else:
        lsetp1 = GridFunction(H1(mesh, order=1, device=device))
        InterpolateToP1(levelset, lsetp1)
    ci = CutInfo(mesh, lsetp1)

    Vh = H1(mesh, order=order, dirichlet=[1, 2, 3, 4], dgjumps=True,
            device=device)
    Vhx = XFESpace(Vh, ci)
    Qh = H1(mesh, order=order - 1, dgjumps=True, device=device)
    Qhx = XFESpace(Qh, ci)
    N = NumberSpace(mesh, device=device)
    WhG = FESpace([Vh, Vhx, Vh, Vhx, Qh, Qhx, N], dgjumps=True)

    u1s, u1x, u2s, u2x, ps, px, lagN = WhG.TrialFunction()
    v1s, v1x, v2s, v2x, qs, qx, lagM = WhG.TestFunction()

    h = specialcf.mesh_size
    n_lset = 1.0 / Norm(grad(lsetp1)) * grad(lsetp1)
    kappa = [CutRatioGF(ci), 1.0 - CutRatioGF(ci)]

    nl0, nl1 = n_lset[0], n_lset[1]

    u1 = [u1s + op(u1x) for op in [neg, pos]]
    u2 = [u2s + op(u2x) for op in [neg, pos]]
    p = [ps + op(px) for op in [neg, pos]]
    gradu1 = [grad(u1s) + op(u1x) for op in [neg_grad, pos_grad]]
    gradu2 = [grad(u2s) + op(u2x) for op in [neg_grad, pos_grad]]
    divu = [gradu1[i][0] + gradu2[i][1] for i in range(2)]
    # (Du n) components, Du = grad u + (grad u)^T (scalar-expanded: the
    # evaluator takes proxy jets through scalar products, not matrix CFs)
    Dun = [(2 * gradu1[i][0] * nl0 + (gradu2[i][0] + gradu1[i][1]) * nl1,
            (gradu2[i][0] + gradu1[i][1]) * nl0 + 2 * gradu2[i][1] * nl1)
           for i in range(2)]
    sigup = [(-mu[i] * Dun[i][0] + p[i] * nl0,
              -mu[i] * Dun[i][1] + p[i] * nl1) for i in range(2)]
    avg_flux_u = [kappa[0] * sigup[0][c] + kappa[1] * sigup[1][c]
                  for c in range(2)]

    v1 = [v1s + op(v1x) for op in [neg, pos]]
    v2 = [v2s + op(v2x) for op in [neg, pos]]
    q = [qs + op(qx) for op in [neg, pos]]
    gradv1 = [grad(v1s) + op(v1x) for op in [neg_grad, pos_grad]]
    gradv2 = [grad(v2s) + op(v2x) for op in [neg_grad, pos_grad]]
    divv = [gradv1[i][0] + gradv2[i][1] for i in range(2)]
    Dvn = [(2 * gradv1[i][0] * nl0 + (gradv2[i][0] + gradv1[i][1]) * nl1,
            (gradv2[i][0] + gradv1[i][1]) * nl0 + 2 * gradv2[i][1] * nl1)
           for i in range(2)]
    sigvq = [(-mu[i] * Dvn[i][0] + q[i] * nl0,
              -mu[i] * Dvn[i][1] + q[i] * nl1) for i in range(2)]
    avg_flux_v = [kappa[0] * sigvq[0][c] + kappa[1] * sigvq[1][c]
                  for c in range(2)]
    avg_inv_v = [-kappa[1] * v1[0] - kappa[0] * v1[1],
                 -kappa[1] * v2[0] - kappa[0] * v2[1]]

    def visc(i):
        return mu[i] * (2 * gradu1[i][0] * gradv1[i][0]
                        + (gradu2[i][0] + gradu1[i][1])
                        * (gradv2[i][0] + gradv1[i][1])
                        + 2 * gradu2[i][1] * gradv2[i][1])

    lset_neg = {"levelset": lsetp1, "domain_type": NEG, "subdivlvl": 0}
    lset_pos = {"levelset": lsetp1, "domain_type": POS, "subdivlvl": 0}
    lset_if = {"levelset": lsetp1, "domain_type": IF, "subdivlvl": 0}

    hasneg = ci.GetElementsOfType(HASNEG)
    haspos = ci.GetElementsOfType(HASPOS)
    hasif = ci.GetElementsOfType(IF)
    ba_facets = [GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif),
                 GetFacetsWithNeighborTypes(mesh, a=haspos, b=hasif)]

    a = BilinearForm(WhG, symmetric=False)
    # viscosity: visc(i) == 0.5*mu_i*InnerProduct(Du_i, Dv_i) scalar-expanded
    a += SymbolicBFI(lset_neg, form=visc(0))
    a += SymbolicBFI(lset_pos, form=visc(1))
    # Nitsche interface coupling (Hansbo averages)
    a += SymbolicBFI(lset_if, form=avg_flux_u[0] * (v1[0] - v1[1])
                     + avg_flux_u[1] * (v2[0] - v2[1]))
    a += SymbolicBFI(lset_if, form=avg_flux_v[0] * (u1[0] - u1[1])
                     + avg_flux_v[1] * (u2[0] - u2[1]))
    a += SymbolicBFI(lset_if, form=lam / h * ((u1[0] - u1[1]) * (v1[0] - v1[1])
                     + (u2[0] - u2[1]) * (v2[0] - v2[1])))
    # pressure terms + zero-mean constraint (NumberSpace multiplier)
    a += SymbolicBFI(lset_neg, form=-divu[0] * q[0] - divv[0] * p[0]
                     + lagN * q[0] + lagM * p[0])
    a += SymbolicBFI(lset_pos, form=-divu[1] * q[1] - divv[1] * p[1])
    # pressure ghost penalty per side (facet-patch volumetric jump form of
    # the reference's dn-jump skeleton stabilization)
    pO = [ps.Other() + op(px.Other()) for op in [neg, pos]]
    qO = [qs.Other() + op(qx.Other()) for op in [neg, pos]]
    for i in range(2):
        a += SymbolicFacetPatchBFI(
            form=-gamma_stab * h * ((p[i] - pO[i]) * (q[i] - qO[i])),
            definedonelements=ba_facets[i])

    f = LinearForm(WhG)
    f += SymbolicLFI(lset_if, form=gammaf * (avg_inv_v[0] * nl0
                                             + avg_inv_v[1] * nl1))
    f += SymbolicLFI(lset_neg, form=src[0] * v1[0] + src[1] * v2[0])
    f += SymbolicLFI(lset_pos, form=src[0] * v1[1] + src[1] * v2[1])

    if deformation is not None:
        mesh.SetDeformation(deformation)
    try:
        a.Assemble()
        f.Assemble()

        gf = GridFunction(WhG)
        gf.components[0].Set(apos * ee * (-1.0) * y)
        gf.components[2].Set(apos * ee * x)

        rhs = f.vec.data - a.mat * gf.vec.data
        free = WhG.FreeDofs()
        if solver == "minres":
            # device-resident iterative solve: the Nitsche-XFEM Stokes
            # operator is symmetric indefinite, so MINRES (abs-Jacobi
            # preconditioned) replaces the host direct factorization
            inv = MinResSolver(a.mat, maxsteps=20000, tol=1e-11,
                               freedofs=free)
        else:
            inv = a.mat.Inverse(free)
        free_t = torch.as_tensor(free.np, device=rhs.device)
        gf.vec.data = gf.vec.data + (inv * torch.where(free_t, rhs, 0.0))

        # errors
        gu1 = [gf.components[0] + op(gf.components[1]) for op in [neg, pos]]
        gu2 = [gf.components[2] + op(gf.components[3]) for op in [neg, pos]]
        gp = [gf.components[4] + op(gf.components[5]) for op in [neg, pos]]
        uerr2 = Integrate(lset_neg, (gu1[0] - vel_neg_ex[0]) ** 2
                          + (gu2[0] - vel_neg_ex[1]) ** 2, mesh,
                          order=2 * order + 2)
        uerr2 += Integrate(lset_pos, (gu1[1] - vel_pos_ex[0]) ** 2
                           + (gu2[1] - vel_pos_ex[1]) ** 2, mesh,
                           order=2 * order + 2)
        perr2 = Integrate(lset_neg, (gp[0] - p_neg_ex) ** 2, mesh,
                          order=2 * order)
        perr2 += Integrate(lset_pos, (gp[1] - p_pos_ex) ** 2, mesh,
                           order=2 * order)
    finally:
        mesh.UnsetDeformation()
    uerr, perr = uerr2 ** 0.5, perr2 ** 0.5
    if verbose:
        print(f"stokesxfem nx={nx} order={order}: "
              f"|u-uex|_L2={uerr:.2e} |p-pex|_L2={perr:.2e}")
    return uerr, perr


if __name__ == "__main__":
    run(nx=8)
    run(nx=16)
