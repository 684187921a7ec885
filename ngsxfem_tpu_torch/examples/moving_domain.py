"""Space-time CutFEM for a moving-domain heat equation.

Counterpart of ``examples/moving_domain.py`` (the reference workload
``py_tutorials/moving_domain.py``, space-time DG convection-diffusion on a
moving level-set domain): per time slab a tensor-product space-time CutFEM
discretization with upwind DG coupling in time and a facet-patch ghost
penalty; the manufactured solution is transported rigidly with the domain
(homogeneous Neumann compatible).  With ``deform=True`` the slab's geometry
is the isoparametric space-time deformation of
``LevelSetMeshAdaptation_Spacetime`` (higher-order geometry), and the
solution is carried across the deformation change at each slab boundary by
``shifted_eval``.  Each slab's non-symmetric system is solved by the host
LU (``a.mat.Inverse``).

Run: ``python -m ngsxfem_tpu_torch.examples.moving_domain``.
"""
import numpy as np

from ngsxfem_tpu_torch import *


def run(nx=16, nslab=8, order=1, kt=1, T=0.5, verbose=True, deform=False,
        device=None):
    """The L2 error at the final time on the final domain."""
    mesh = MakeStructured2DMesh(
        quads=False, nx=nx, ny=nx, mapping=lambda a, b: (2 * a - 1, 2 * b - 1)
    )
    r = 0.5
    wvel = 0.4  # x-velocity of the domain
    c0x = -0.2
    dtt = T / nslab

    t_start = Parameter(0.0)
    t_abs = t_start + dtt * tref  # absolute time as a CF
    cx = c0x + wvel * t_abs
    rho2 = (x - cx) * (x - cx) + y * y

    # exact solution u = (rho^2-r^2)^2/r^4 (rigidly transported, so its
    # material derivative is zero); f = -lap(u)
    def exact_at(tv):
        cxv = c0x + wvel * tv
        r2 = (x - cxv) * (x - cxv) + y * y
        return (r2 - r * r) * (r2 - r * r) / r**4

    f_cf = -(8 * rho2 + 8 * (rho2 - r * r)) / r**4

    Vh = H1(mesh, order=order, dgjumps=True, device=device)
    W = SpaceTimeFESpace(Vh, ScalarTimeFE(kt))
    u, v = W.TnT()

    levelset = sqrt(rho2) - r

    lset_bot = GridFunction(H1(mesh, order=1, device=device))
    uold = GridFunction(Vh)
    gfu = GridFunction(W)

    # isoparametric space-time deformation (higher-order geometry,
    # reference spacetime/lset_spacetime.py)
    if deform:
        lsetadap = LevelSetMeshAdaptation_Spacetime(
            mesh, order_space=order, order_time=kt, threshold=0.5,
            device=device)
        lset_st = lsetadap.lset_p1
        deform_st = lsetadap.deform
        deform_bot = GridFunction(lsetadap.nodal.deform_space)
        deform_top = GridFunction(lsetadap.nodal.deform_space)
        utmp = GridFunction(Vh)
        dfm_st, dfm_bot = deform_st, deform_bot
    else:
        lset_st = GridFunction(
            W if order == 1
            else SpaceTimeFESpace(H1(mesh, 1, device=device), ScalarTimeFE(kt)))
        dfm_st = dfm_bot = None

    # ghost-penalty facet band: a superset (elements near the interface at
    # any time), narrowed per slab below
    verts = mesh.vertices_np
    dmin = np.full(mesh.nv, np.inf)
    for tv in np.linspace(0, T, 4 * nslab + 1):
        c = np.array([c0x + wvel * tv, 0.0])
        dmin = np.minimum(dmin, np.abs(np.hypot(*(verts - c).T) - r))
    band_v = dmin < 2.5 / nx
    band_el = band_v[mesh.elements_np].any(axis=1)
    f2e = mesh.facet2el_np
    inter = f2e[:, 1] >= 0
    gp_facets = BitArray(
        inter & band_el[np.maximum(f2e[:, 0], 0)] & band_el[np.maximum(f2e[:, 1], 0)]
    )

    h = specialcf.mesh_size
    wcf = CoefficientFunction((wvel, 0.0))
    lset_dom = {"levelset": lset_st, "domain_type": NEG}
    lset_bot_dom = {"levelset": lset_bot, "domain_type": NEG}

    hasneg = np.ones(mesh.ne, dtype=bool)  # re-marked per slab

    # time derivative in reference coordinates; under a time-dependent mesh
    # deformation psi the physical time derivative needs the mesh-velocity
    # correction dt(u) - dt(psi).grad(u) (the reference's deformed
    # space-time DG formulation, xfem jupyter spacetimeDG_unfitted)
    if deform:
        dtu = dt(u) - InnerProduct(dt(deform_st), grad(u))
    else:
        dtu = dt(u)
    a = BilinearForm(W)
    a += SymbolicBFI(
        lset_dom,
        form=dtu * v + dtt * ((wcf * grad(u)) * v + grad(u) * grad(v)),
        time_order=2 * kt + 1, definedonelements=hasneg, deformation=dfm_st,
    )
    a += SymbolicBFI(lset_bot_dom, form=fix_t(u, 0.0) * fix_t(v, 0.0),
                     definedonelements=hasneg, deformation=dfm_bot)
    a += SymbolicFacetPatchBFI(
        form=dtt * 1.0 / (h * h) * (u - u.Other()) * (v - v.Other()),
        time_order=kt, definedonelements=gp_facets, deformation=dfm_st,
    )

    fl = LinearForm(W)
    fl += SymbolicLFI(lset_dom, form=dtt * f_cf * v, time_order=2 * kt + 1,
                      definedonelements=hasneg, deformation=dfm_st)
    fl += SymbolicLFI(lset_bot_dom, form=uold * fix_t(v, 0.0),
                      definedonelements=hasneg, deformation=dfm_bot)

    ci = CutInfo(mesh)

    for s in range(nslab):
        t0 = s * dtt
        t_start.Set(t0)
        if deform:
            lsetadap.CalcDeformation(levelset)
            RestrictGFInTime(spacetime_gf=deform_st, reference_time=0.0,
                             space_gf=deform_bot)
            if s == 0:
                mesh.SetDeformation(deform_bot)
                uold.Set(exact_at(0.0))
                mesh.UnsetDeformation()
            else:
                # carry uold across the deformation change at the slab start
                utmp.vec.data = uold.vec.data
                uold.Set(shifted_eval(utmp, back=deform_top, forth=deform_bot))
            RestrictGFInTime(spacetime_gf=deform_st, reference_time=1.0,
                             space_gf=deform_top)
        else:
            if s == 0:
                uold.Set(exact_at(0.0))
            SpaceTimeInterpolateToP1(levelset, tref, lset_st)
        RestrictGFInTime(spacetime_gf=lset_st, reference_time=0.0, space_gf=lset_bot)
        ci.Update(lset_st, time_order=kt)
        hn = ci.GetElementsOfType(HASNEG).np
        # per-slab narrow ghost-penalty band
        gp_now = GetFacetsWithNeighborTypes(
            mesh, a=ci.GetElementsOfType(HASNEG), b=ci.GetElementsOfType(IF))
        for integ in list(a.integrals) + list(fl.integrals):
            if integ.facet_patch:
                integ.definedonelements = np.asarray(gp_now.np) & np.asarray(
                    gp_facets.np)
            elif integ.definedonelements is not None:
                integ.definedonelements = hn

        a.Assemble()
        fl.Assemble()
        active = GetDofsOfElements(W, BitArray(hn))
        gfu.vec.data = a.mat.Inverse(active) * fl.vec.data
        RestrictGFInTime(spacetime_gf=gfu, reference_time=1.0, space_gf=uold)
        if verbose:
            print(f"slab {s}: t=[{t0:.3f},{t0+dtt:.3f}]", flush=True)

    # error at the final time on the final domain: the last slab's level set
    # at tref=1 is the t=T geometry, and deform_top of that slab is the
    # matching deformation
    RestrictGFInTime(spacetime_gf=lset_st, reference_time=1.0,
                     space_gf=lset_bot)
    err_dfm = deform_top if deform else None
    err_cf = (uold - exact_at(T)) * (uold - exact_at(T))
    l2err = Integrate(
        {"levelset": lset_bot, "domain_type": NEG}, err_cf, mesh,
        order=2 * order + 2, deformation=err_dfm,
    ) ** 0.5
    if verbose:
        print("final-time L2 error:", l2err)
    return l2err


if __name__ == "__main__":
    run()
