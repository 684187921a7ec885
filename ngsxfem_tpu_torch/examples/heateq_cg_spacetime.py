"""Unfitted heat equation, CG in time (Petrov-Galerkin) space-time CutFEM.

Counterpart of ``examples/heateq_cg_spacetime.py`` (the reference demo
``spacetime/py_demos/spaceP1_timeCGP1.py``): the moving-disk heat equation
with a continuous-in-time trial space split into an interior part
(``ScalarTimeFE(1, skip_first_node=True)``, the unknowns) and an
initial-value part (``ScalarTimeFE(1, only_first_node=True)``, set weakly
from the previous slab), tested against a P0-in-time space: one
rectangular system per block, assembled with
``BilinearForm(trialspace=..., testspace=...)``, and per slab one solve of
the square interior block by the host LU (the system is not symmetric).

The analytic case: a disk of radius r0 oscillating vertically
(rho(t) = sin(2*pi*t)/pi), exact solution u = cos(Q*r)*sin(pi*t),
Q = pi/r0 (homogeneous Neumann on the moving boundary), convection velocity
w = (0, rho').

Run: ``python -m ngsxfem_tpu_torch.examples.heateq_cg_spacetime``.
"""
from math import pi

import numpy as np

from ngsxfem_tpu_torch import *


def run(nx=24, nslab=16, tend=0.5, verbose=True, device=None):
    """The per-slab L2 errors at the top of each slab (a list)."""
    mesh = MakeStructured2DMesh(
        quads=False, nx=nx, ny=nx, mapping=lambda a, b: (2 * a - 1, 2 * b - 1)
    )
    r0 = 0.5
    alpha = 1.0
    dtt = tend / nslab

    told = Parameter(0.0)
    t = told + dtt * tref  # absolute time within the slab

    # geometry: disk oscillating vertically (reference case 1)
    rho = (1.0 / pi) * sin(2 * pi * t)
    d_rho = 2 * cos(2 * pi * t)
    w = CoefficientFunction((0.0, d_rho))
    rr = sqrt(x * x + (y - rho) * (y - rho))
    levelset = rr - r0

    Q = pi / r0
    coeff_f = ((Q / rr * sin(Q * rr) + Q * Q * cos(Q * rr)) * sin(pi * t)
               + pi * cos(Q * rr) * cos(pi * t))

    def exact_at(tv):
        rho_v = (1.0 / pi) * np.sin(2 * pi * tv)
        r_v = sqrt(x * x + (y - rho_v) * (y - rho_v))
        return cos(Q * r_v) * np.sin(pi * tv)

    # spaces: interior trial (active time node only), exterior/initial trial
    # (first time node only), P0-in-time test (reference st_fes_i/e/t)
    fes1 = H1(mesh, order=1, dgjumps=True, device=device)
    W_i = SpaceTimeFESpace(fes1, ScalarTimeFE(1, skip_first_node=True))
    W_e = SpaceTimeFESpace(fes1, ScalarTimeFE(1, only_first_node=True))
    W_t = SpaceTimeFESpace(fes1, ScalarTimeFE(0))
    time_order = 2

    lset_p1 = GridFunction(SpaceTimeFESpace(H1(mesh, order=1, device=device),
                                            ScalarTimeFE(1)))
    SpaceTimeInterpolateToP1(levelset, tref, lset_p1)
    lset_top = CreateTimeRestrictedGF(lset_p1, 1.0)
    lset_bottom = CreateTimeRestrictedGF(lset_p1, 0.0)

    gfu_i = GridFunction(W_i)
    gfu_e = GridFunction(W_e)
    u_last = CreateTimeRestrictedGF(gfu_e, 0.0)
    SpaceTimeWeakSet(gfu_e, exact_at(0.0), fes1)

    u_i = W_i.TrialFunction()
    u_e = W_e.TrialFunction()
    v_t = W_t.TestFunction()
    h = specialcf.mesh_size
    lset_neg = {"levelset": lset_p1, "domain_type": NEG}
    lset_neg_top = {"levelset": lset_top, "domain_type": NEG}
    lset_neg_bottom = {"levelset": lset_bottom, "domain_type": NEG}

    hasneg = np.ones(mesh.ne, dtype=bool)  # re-marked per slab
    gp_facets = np.ones(len(mesh.facet2el_np), dtype=bool)

    # the reference demo's integrator lists: the same volume/ghost-penalty
    # terms for both trial blocks, plus the time-boundary coupling terms
    # (upper trace for the interior block, minus the lower trace for the
    # initial-value block, moved to the right-hand side at solve time)
    def blocks(u, W_u, extra):
        a = BilinearForm(trialspace=W_u, testspace=W_t)
        a += SymbolicBFI(lset_neg, form=-u * dt(v_t), time_order=time_order,
                         definedonelements=hasneg)
        a += SymbolicBFI(lset_neg,
                         form=-dtt * u * InnerProduct(w, grad(v_t)),
                         time_order=time_order, definedonelements=hasneg)
        a += SymbolicBFI(lset_neg, form=dtt * alpha * grad(u) * grad(v_t),
                         time_order=time_order, definedonelements=hasneg)
        a += SymbolicFacetPatchBFI(
            form=dtt * 1.05 / (h * h) * (u - u.Other()) * (v_t - v_t.Other()),
            time_order=time_order, definedonelements=gp_facets)
        a += extra
        return a

    a_i = blocks(u_i, W_i,
                 SymbolicBFI(lset_neg_top,
                             form=fix_t(u_i, 1.0) * fix_t(v_t, 1.0),
                             definedonelements=hasneg))
    a_e = blocks(u_e, W_e,
                 SymbolicBFI(lset_neg_bottom,
                             form=-fix_t(u_e, 0.0) * fix_t(v_t, 0.0),
                             definedonelements=hasneg))

    f = LinearForm(W_t)
    f += SymbolicLFI(lset_neg, form=dtt * coeff_f * v_t,
                     time_order=time_order, definedonelements=hasneg)

    ci = CutInfo(mesh)
    errs = []
    for s in range(nslab):
        told.Set(s * dtt)
        SpaceTimeInterpolateToP1(levelset, tref, lset_p1)
        RestrictGFInTime(spacetime_gf=lset_p1, reference_time=1.0,
                         space_gf=lset_top)
        RestrictGFInTime(spacetime_gf=lset_p1, reference_time=0.0,
                         space_gf=lset_bottom)
        ci.Update(lset_p1, time_order=time_order)
        hn = ci.GetElementsOfType(HASNEG).np
        ba_facets = GetFacetsWithNeighborTypes(
            mesh, a=ci.GetElementsOfType(HASNEG),
            b=ci.GetElementsOfType(IF))
        for form_obj in (a_i, a_e, f):
            for integ in form_obj.integrals:
                if integ.facet_patch:
                    integ.definedonelements = np.asarray(ba_facets.np)
                elif integ.definedonelements is not None:
                    integ.definedonelements = hn

        a_i.Assemble()
        a_e.Assemble()
        f.Assemble()

        active = GetDofsOfElements(W_i, ci.GetElementsOfType(HASNEG))
        rhs = f.vec.data - a_e.mat * gfu_e.vec.data
        gfu_i.vec.data = a_i.mat.Inverse(active) * rhs

        RestrictGFInTime(spacetime_gf=gfu_i, reference_time=1.0,
                         space_gf=u_last)
        SpaceTimeWeakSet(gfu_e, u_last, fes1)

        tnew = (s + 1) * dtt
        l2err = Integrate(lset_neg_top,
                          (exact_at(tnew) - u_last) ** 2, mesh,
                          order=4) ** 0.5
        errs.append(l2err)
        if verbose:
            print(f"t = {tnew:8.4f}, l2error = {l2err:.6e}", flush=True)
    return errs


if __name__ == "__main__":
    run()
