"""Space-time CutFEM for a 3D moving-domain heat equation.

Counterpart of ``examples/moving_domain3d.py`` (beyond the reference's
2D-only ``py_tutorials/moving_domain.py``): a sphere of radius r
translating through a structured tet mesh of [-1,1]^3, tensor-product
space-time CutFEM with upwind DG coupling in time, a facet-patch ghost
penalty and per-slab re-marking of the active element and facet sets.  The
manufactured solution is transported rigidly with the domain (material
derivative zero, homogeneous-Neumann compatible), so the final-time L2
error measures the whole 3D space-time discretization.

Run: ``python -m ngsxfem_tpu_torch.examples.moving_domain3d``.
"""
import numpy as np

from ngsxfem_tpu_torch import *


def run(nx=8, nslab=4, kt=1, T=0.25, verbose=True, device=None):
    """The L2 error at the final time on the final domain."""
    mesh = MakeStructured3DMesh(
        hexes=False, nx=nx, ny=nx, nz=nx,
        mapping=lambda a, b, c: (2 * a - 1, 2 * b - 1, 2 * c - 1))
    r = 0.5
    wvel = 0.4  # x-velocity of the domain
    c0x = -0.1
    dtt = T / nslab

    t_start = Parameter(0.0)
    t_abs = t_start + dtt * tref
    cx = c0x + wvel * t_abs
    rho2 = (x - cx) ** 2 + y * y + z * z

    # u = (rho^2 - r^2)^2 / r^4 rigidly transported; in 3D
    # -lap(u) = -(8*rho2 + 12*(rho2 - r^2)) / r^4
    def exact_at(tv):
        cxv = c0x + wvel * tv
        s = (x - cxv) ** 2 + y * y + z * z
        return (s - r * r) * (s - r * r) / r**4

    f_cf = -(8 * rho2 + 12 * (rho2 - r * r)) / r**4

    Vh = H1(mesh, order=1, dgjumps=True, device=device)
    W = SpaceTimeFESpace(Vh, ScalarTimeFE(kt))
    u, v = W.TnT()

    levelset = sqrt(rho2) - r
    lset_st = GridFunction(W)
    lset_bot = GridFunction(H1(mesh, order=1, device=device))
    uold = GridFunction(Vh)
    gfu = GridFunction(W)

    # a band of facets near the interface at any time of [0, T], narrowed
    # per slab below
    verts = mesh.vertices_np
    dmin = np.full(mesh.nv, np.inf)
    for tv in np.linspace(0, T, 4 * nslab + 1):
        c = np.array([c0x + wvel * tv, 0.0, 0.0])
        dd = np.sqrt(((verts - c) ** 2).sum(1))
        dmin = np.minimum(dmin, np.abs(dd - r))
    band_v = dmin < 3.0 / nx
    band_el = band_v[mesh.elements_np].any(axis=1)
    f2e = mesh.facet2el_np
    inter = f2e[:, 1] >= 0
    gp_facets = BitArray(
        inter & band_el[np.maximum(f2e[:, 0], 0)]
        & band_el[np.maximum(f2e[:, 1], 0)])

    h = specialcf.mesh_size
    wcf = CoefficientFunction((wvel, 0.0, 0.0))
    lset_dom = {"levelset": lset_st, "domain_type": NEG}
    lset_bot_dom = {"levelset": lset_bot, "domain_type": NEG}

    hasneg = np.ones(mesh.ne, dtype=bool)  # re-marked per slab

    a = BilinearForm(W)
    a += SymbolicBFI(
        lset_dom,
        form=dt(u) * v + dtt * ((wcf * grad(u)) * v + grad(u) * grad(v)),
        time_order=2 * kt + 1, definedonelements=hasneg)
    a += SymbolicBFI(lset_bot_dom, form=fix_t(u, 0.0) * fix_t(v, 0.0),
                     definedonelements=hasneg)
    a += SymbolicFacetPatchBFI(
        form=dtt * 1.0 / (h * h) * (u - u.Other()) * (v - v.Other()),
        time_order=kt, definedonelements=gp_facets)

    fl = LinearForm(W)
    fl += SymbolicLFI(lset_dom, form=dtt * f_cf * v, time_order=2 * kt + 1,
                      definedonelements=hasneg)
    fl += SymbolicLFI(lset_bot_dom, form=uold * fix_t(v, 0.0),
                      definedonelements=hasneg)

    ci = CutInfo(mesh)
    for s in range(nslab):
        t0 = s * dtt
        t_start.Set(t0)
        if s == 0:
            uold.Set(exact_at(0.0))
        SpaceTimeInterpolateToP1(levelset, tref, lset_st)
        RestrictGFInTime(spacetime_gf=lset_st, reference_time=0.0,
                         space_gf=lset_bot)
        ci.Update(lset_st, time_order=kt)
        hn = ci.GetElementsOfType(HASNEG).np
        gp_now = GetFacetsWithNeighborTypes(
            mesh, a=ci.GetElementsOfType(HASNEG), b=ci.GetElementsOfType(IF))
        for integ in list(a.integrals) + list(fl.integrals):
            if integ.facet_patch:
                integ.definedonelements = (np.asarray(gp_now.np)
                                           & np.asarray(gp_facets.np))
            elif integ.definedonelements is not None:
                integ.definedonelements = hn

        a.Assemble()
        fl.Assemble()
        active = GetDofsOfElements(W, BitArray(hn))
        gfu.vec.data = a.mat.Inverse(active) * fl.vec.data
        RestrictGFInTime(spacetime_gf=gfu, reference_time=1.0, space_gf=uold)
        if verbose:
            print(f"slab {s}: t=[{t0:.3f},{t0 + dtt:.3f}]", flush=True)

    RestrictGFInTime(spacetime_gf=lset_st, reference_time=1.0,
                     space_gf=lset_bot)
    err_cf = (uold - exact_at(T)) * (uold - exact_at(T))
    l2err = Integrate({"levelset": lset_bot, "domain_type": NEG}, err_cf,
                      mesh, order=4) ** 0.5
    if verbose:
        print("final-time L2 error:", l2err)
    return l2err


if __name__ == "__main__":
    run()
