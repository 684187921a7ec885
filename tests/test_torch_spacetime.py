"""Space-time unfitted FEM of the PyTorch port against the JAX package.

The same seeded inputs go through ``ngsxfem_tpu`` (CPU, x64) and
``ngsxfem_tpu_torch`` (tensors on the CPU, float64):

- ``ScalarTimeFE`` bases and derivatives, all three node variants, to
  1e-15 (of the largest value, at least 1);
- ``spacetime_cut_rule`` on trig/quad/tet for kt = 1, 2, 3: points (where
  the weight exceeds 1e-13), times, weights, sides, interface normals
  elementwise to 1e-12, per-element weight sums and integrals of
  space-time monomials to 1e-12;
- ``Integrate(time_order=)`` for NEG/POS/IF (the exact cases of the
  reference's test_spacetimecutrule.py to 1e-13, random level sets vs the
  JAX package to 1e-12), ``CutInfo.Update(time_order=)`` (``dt_of_elem``
  equal, cut ratios to 1e-12);
- ``a.mat.todense()`` / ``f.vec`` of the space-time forms (volume,
  facet-patch, skeleton, element-boundary, BND and Petrov-Galerkin, and the
  deformed space-time forms of ``moving_domain(deform=True)``) to 1e-12 of
  the largest entry, ``LevelSetMeshAdaptation_Spacetime.deform`` to 1e-12;
- the three examples' L2 errors to 1e-9 relative;

and the convergence and exactness checks of the JAX package's space-time
tests run on the port with their own thresholds at their own sizes.
"""
from math import pi, log as mlog, sqrt as msqrt

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu.ops import spacetimecut as j_stc
from ngsxfem_tpu_torch.ops import spacetimecut as t_stc

CPU = {"device": "cpu"}
PKGS = [(J, {}), (T, CPU)]


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(a, b, tol=1e-12):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(initial=0.0), 1e-300)
    assert np.abs(a - b).max(initial=0.0) <= tol * scale, \
        np.abs(a - b).max() / scale


# -- time finite elements -----------------------------------------------------

@pytest.mark.parametrize("order", [0, 1, 2, 3])
@pytest.mark.parametrize("variant", ["full", "skip_first_node",
                                     "only_first_node"])
def test_time_fe_bases(order, variant):
    kw = {} if variant == "full" else {variant: True}
    fj, ft = J.ScalarTimeFE(order, **kw), T.ScalarTimeFE(order, **kw)
    assert np.array_equal(fj.nodes, ft.nodes) and fj.ndof == ft.ndof
    assert [fj.IsNodeActive(i) for i in range(order + 1)] == \
        [ft.IsNodeActive(i) for i in range(order + 1)]
    t = np.random.default_rng(order).uniform(0, 1, (7, 5))
    for name in ("eval", "deval"):
        a = np.asarray(getattr(fj, name)(jnp.asarray(t)))
        b = _np(getattr(ft, name)(torch.as_tensor(t)))
        scale = max(np.abs(a).max(initial=0.0), 1.0)
        assert a.shape == b.shape
        assert np.abs(a - b).max(initial=0.0) <= 1e-15 * scale, name
    assert np.array_equal(fj.eval_np(t), ft.eval_np(t))


def test_gauss_lobatto_copy():
    from ngsxfem_tpu.ops.gauss import gauss_lobatto_01 as jgl
    from ngsxfem_tpu_torch.ops.gauss import gauss_lobatto_01 as tgl

    for n in range(2, 7):
        for a, b in zip(jgl(n), tgl(n)):
            assert np.array_equal(a, b)


# -- the space-time cut rule --------------------------------------------------

NVERT = {"trig": 3, "quad": 4, "tet": 4}


def _st_vals(et, kt, seed):
    """Seeded (E, kt+1, nvel) nodal level-set values: random rows, rows of
    one sign (uncut), and rows whose sign change is driven by time.  (A cut
    point moves by rounding / |spatial gradient|; the time-driven rows keep
    that gradient O(0.1) so that points compare to 1e-12.)"""
    rng = np.random.default_rng(seed)
    nv = NVERT[et]
    v = rng.standard_normal((24, kt + 1, nv))
    v[:4] = np.abs(v[:4]) + 0.1
    v[4:8] = -np.abs(v[4:8]) - 0.1
    v[8:12] = np.linspace(-1.0, 1.0, kt + 1)[None, :, None] + \
        0.1 * rng.standard_normal((4, kt + 1, nv))
    return v


@pytest.mark.parametrize("et", ["trig", "quad", "tet"])
@pytest.mark.parametrize("kt", [1, 2, 3])
def test_spacetime_cut_rule_matches_jax(et, kt):
    v = _st_vals(et, kt, seed=100 * kt + len(et))
    rj = j_stc.spacetime_cut_rule(et, jnp.asarray(v), kt, 2, 2 * kt)
    rt = t_stc.spacetime_cut_rule(et, torch.as_tensor(v), kt, 2, 2 * kt)
    for name in ("times", "w", "side", "times_if", "w_if"):
        a, b = np.asarray(getattr(rj, name)), _np(getattr(rt, name))
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1e-12, name
    for name, wname in (("pts", "w"), ("pts_if", "w_if"), ("nref", "w_if")):
        keep = (np.asarray(getattr(rj, wname)) > 1e-13)[..., None]
        a, b = np.asarray(getattr(rj, name)), _np(getattr(rt, name))
        assert np.abs(np.where(keep, a - b, 0.0)).max() <= 1e-12, name
    # per-element sums and space-time moments of each side and the interface
    d = rj.pts.shape[-1]
    for side in (0, 1):
        for k in range(3):
            mono = lambda r, P: (P(r.pts)[..., 0] ** k * P(r.times) ** (2 - k)
                                 * P(r.w) * (P(r.side) == side))
            _close(mono(rt, _np).sum(1), mono(rj, np.asarray).sum(1))
    for k in range(3):
        mono_if = lambda r, P: (P(r.pts_if)[..., d - 1] ** k
                                * P(r.times_if) * P(r.w_if))
        _close(mono_if(rt, _np).sum(1), mono_if(rj, np.asarray).sum(1))


@pytest.mark.parametrize("kt", [1, 2, 3])
def test_poly_roots_match_jax(kt):
    rng = np.random.default_rng(kt)
    c = rng.standard_normal((50, 4, kt + 1))
    c[:5, :, -1] = 0.0  # degenerate leading coefficients
    a = np.asarray(j_stc._poly_roots_in_01(jnp.asarray(c), kt))
    b = _np(t_stc._poly_roots_in_01(torch.as_tensor(c), kt))
    assert np.abs(a - b).max() <= 1e-12


@pytest.mark.parametrize("et", ["trig", "quad", "tet"])
def test_spacetime_split_is_the_plain_rule(et):
    """Elements that ``spacetime_split`` takes as plain get exactly the
    weight 1 of one side from the cut rule (so the two-tier integral equals
    the JAX package's one-tier one)."""
    v = _st_vals(et, 1, seed=7)
    split = _np(t_stc.spacetime_split(torch.as_tensor(v), 1, 2))
    r = t_stc.spacetime_cut_rule(et, torch.as_tensor(v), 1, 2, 2)
    w, side = _np(r.w), _np(r.side)
    for e in np.nonzero(split >= 0)[0]:
        assert abs(w[e].sum() - (1.0 if et == "quad" else 0.5 if et == "trig"
                                 else 1 / 6)) < 1e-14
        assert abs((w[e] * (side[e] == split[e])).sum() - w[e].sum()) < 1e-15
    assert (split >= 0).sum() >= 8 and (split < 0).sum() >= 8


# -- Integrate and CutInfo ------------------------------------------------------

def _st_lset(N, kw, mesh, kt, phi):
    st = N.SpaceTimeFESpace(N.H1(mesh, order=1, **kw), N.ScalarTimeFE(kt))
    gf = N.GridFunction(st)
    N.SpaceTimeInterpolateToP1(phi(N), N.tref, gf)
    return gf


def _mesh(N, et, nx):
    if et == "tet":
        return N.MakeStructured3DMesh(hexes=False, nx=nx, ny=nx, nz=nx)
    return N.MakeStructured2DMesh(quads=et == "quad", nx=nx, ny=nx)


def _circle(N):
    return N.sqrt((N.x - 0.35 - 0.3 * N.tref) ** 2 + (N.y - 0.5) ** 2
                  + (N.z - 0.5) ** 2 * 0.0) - 0.3


@pytest.mark.parametrize("et", ["trig", "quad", "tet"])
@pytest.mark.parametrize("kt", [1, 2])
def test_integrate_matches_jax(et, kt):
    out = {}
    for N, kw in PKGS:
        mesh = _mesh(N, et, 3 if et == "tet" else 6)
        lset = _st_lset(N, kw, mesh, kt, _circle)
        f = 1 + N.sin(N.x * N.tref) + N.exp(N.y) * N.tref ** 3
        out[N] = [N.Integrate({"levelset": lset, "domain_type": dom}, f,
                              mesh, order=3, time_order=4)
                  for dom in (N.NEG, N.POS, N.IF)]
        out[N].append(_np(N.Integrate(
            {"levelset": lset, "domain_type": N.NEG}, f, mesh, order=2,
            time_order=3, element_wise=True)))
    for a, b in zip(out[T], out[J]):
        _close(a, b)
    # the one-tier rule (cut rule on every element) integrates alike
    from ngsxfem_tpu_torch.cf.context import eval_pure
    from ngsxfem_tpu_torch.integrate import _cut_ctx_and_weights

    mesh = _mesh(T, et, 3 if et == "tet" else 6)
    lset = _st_lset(T, CPU, mesh, kt, _circle)
    f = 1 + T.sin(T.x * T.tref) + T.exp(T.y) * T.tref ** 3
    for k, dom in enumerate((T.NEG, T.POS, T.IF)):
        ctx, w, m = _cut_ctx_and_weights(mesh, lset, dom, 3, time_order=4)
        got = float((torch.where(m, torch.broadcast_to(eval_pure(f, ctx),
                                                       w.shape), 0.0) * w).sum())
        _close(got, out[J][k])


@pytest.mark.parametrize("dom,expect", [("NEG", 0.5), ("POS", 0.5),
                                        ("IF", 1.0)])
def test_st_exact_1d(dom, expect):
    mesh = T.Make1DMesh(5)
    lset = _st_lset(T, CPU, mesh, 1, lambda N: N.x - 0.3 - 0.4 * N.tref)
    v = T.Integrate({"levelset": lset, "domain_type": getattr(T, dom)},
                    T.CoefficientFunction(1.0), mesh, order=3, time_order=2)
    assert abs(v - expect) < 1e-13


def test_st_exact_quadratic_time():
    mesh = T.Make1DMesh(4)
    lset = _st_lset(T, CPU, mesh, 2, lambda N: N.x - 0.3 - 0.2 * N.tref ** 2)
    v = T.Integrate({"levelset": lset, "domain_type": T.NEG},
                    T.CoefficientFunction(1.0), mesh, order=3, time_order=4)
    assert abs(v - (0.3 + 0.2 / 3)) < 1e-13


@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("case", range(5))
def test_spacetime_integrate_no_cut(quad, case):
    """Reference ``test_spacetime_integrate_no_cut``: exact space-time
    monomials on an uncut domain."""
    tref, x, y = T.tref, T.x, T.y
    f, ref_value, space_order, time_order = [
        (tref, 0.5, 0, 1), (tref ** 3, 0.25, 0, 3),
        ((1 - tref) ** 3, 0.25, 0, 3), (x, 0.5, 1, 0),
        (tref * tref * (x * x + y * y), 2 / 9, 2, 2)][case]
    mesh = T.MakeStructured2DMesh(quads=quad, nx=1, ny=1)
    fes = T.SpaceTimeFESpace(T.H1(mesh, order=1, **CPU), T.ScalarTimeFE(1))
    lset = T.GridFunction(fes)
    lset.vec[:] = -1
    got = T.Integrate({"levelset": lset, "domain_type": T.NEG}, cf=f,
                      mesh=mesh, order=space_order, time_order=time_order)
    assert abs(got - ref_value) < 5e-15


@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("dom", ["NEG", "POS", "IF"])
def test_spacetime_integrate_via_vec_blocks(dom, quad):
    """Reference ``test_spacetime_integrateX_via_straight_cutted_quad2Dplus1D``:
    a space-time level set filled block by block through ``vec``."""
    mesh = T.MakeStructured2DMesh(quads=quad, nx=1, ny=1)
    h1 = T.H1(mesh, order=1, **CPU)
    l1 = T.GridFunction(h1)
    lset = T.GridFunction(T.SpaceTimeFESpace(h1, T.ScalarTimeFE(1)))
    T.InterpolateToP1(1 - 2 * T.x, l1)
    lset.vec[0:h1.ndof] = l1.vec.NumPy()
    T.InterpolateToP1(1 - 2 * T.x - 2, l1)
    lset.vec[h1.ndof:2 * h1.ndof] = l1.vec.NumPy()
    ref = {"POS": 1.0 / 8, "NEG": 1 - 1.0 / 8, "IF": 1.0 / 2}[dom]
    got = T.Integrate({"levelset": lset, "domain_type": getattr(T, dom)},
                      cf=T.CoefficientFunction(1), mesh=mesh, order=0,
                      time_order=0)
    assert abs(got - ref) < 5e-15


def test_st_kt3_multiroot_exact():
    mesh = T.MakeStructured2DMesh(quads=False, nx=4, ny=4)
    a, r0, r1, r2 = 2.5, 0.1, 0.45, 0.95
    lset = _st_lset(T, CPU, mesh, 3, lambda N: N.x - (
        0.55 + a * (N.tref - r0) * (N.tref - r1) * (N.tref - r2)))
    c3 = np.polynomial.Polynomial.fromroots([r0, r1, r2]) * a + 0.55
    exact = c3.integ()(1.0) - c3.integ()(0.0)
    for dom, ref in ((T.NEG, exact), (T.POS, 1 - exact), (T.IF, 1.0)):
        v = T.Integrate({"levelset": lset, "domain_type": dom},
                        T.CoefficientFunction(1.0), mesh, order=2,
                        time_order=8)
        assert abs(v - ref) < 1e-12, (int(dom), v, ref)


@pytest.mark.parametrize("et", ["trig", "quad", "tet"])
@pytest.mark.parametrize("kt", [1, 2])
def test_cutinfo_matches_jax(et, kt):
    got = {}
    for N, kw in PKGS:
        mesh = _mesh(N, et, 3 if et == "tet" else 6)
        ci = N.CutInfo(mesh)
        ci.Update(_st_lset(N, kw, mesh, kt, _circle), time_order=2)
        got[N] = ci
    assert np.array_equal(got[T].dt_of_elem, got[J].dt_of_elem)
    assert np.array_equal(got[T].cdt_of_facet, got[J].cdt_of_facet)
    assert np.abs(got[T].GetCutRatios() - got[J].GetCutRatios()).max() <= 1e-12
    assert 0 < got[T].GetElementsOfType(T.IF).NumSet() < len(got[T].dt_of_elem)
    with pytest.raises(NotImplementedError):
        got[T].GetElementsOfType(T.IF, VOL_or_BND=T.BND)


def test_spatial_levelset_with_time_order_matches_jax():
    """A spatial level set under ``time_order >= 0`` is constant in time
    (the reference's fitted heat solve routes it so)."""
    out = {}
    for N, kw in PKGS:
        mesh = N.MakeStructured2DMesh(quads=False, nx=5, ny=5)
        lset = N.GridFunction(N.H1(mesh, order=1, **kw))
        N.InterpolateToP1(N.x - 0.37, lset)
        f = N.exp(N.x * N.tref)
        out[N] = [N.Integrate({"levelset": lset, "domain_type": d}, f, mesh,
                              order=3, time_order=2) for d in (N.NEG, N.IF)]
    _close(out[T], out[J])


# -- forms ----------------------------------------------------------------------

def _dg_forms(N, kw, nx=6):
    """One slab of the space-time DG moving-circle forms, with every
    integral kind under ``time_order``."""
    mesh = N.MakeStructured2DMesh(
        quads=False, nx=nx, ny=nx, mapping=lambda a, b: (2 * a - 1, 2 * b - 1))
    Vh = N.H1(mesh, order=1, dgjumps=True, **kw)
    W = N.SpaceTimeFESpace(Vh, N.ScalarTimeFE(1))
    u, v = W.TnT()
    lset = _st_lset(N, kw, mesh, 1, lambda M: M.sqrt(
        (M.x + 0.2 - 0.3 * M.tref) ** 2 + M.y * M.y) - 0.5)
    lbot = N.CreateTimeRestrictedGF(lset, 0.0)
    ci = N.CutInfo(mesh)
    ci.Update(lset, time_order=1)
    hn = ci.GetElementsOfType(N.HASNEG).np
    band = N.GetFacetsWithNeighborTypes(
        mesh, a=ci.GetElementsOfType(N.HASNEG),
        b=ci.GetElementsOfType(N.IF)).np
    h = N.specialcf.mesh_size
    w = N.CoefficientFunction((0.4, 0.0))
    dom = {"levelset": lset, "domain_type": N.NEG}
    a = N.BilinearForm(W)
    a += N.SymbolicBFI(dom, form=N.dt(u) * v + 0.1 * ((w * N.grad(u)) * v
                                                      + N.grad(u) * N.grad(v)),
                       time_order=3, definedonelements=hn)
    a += N.SymbolicBFI({"levelset": lbot, "domain_type": N.NEG},
                       form=N.fix_t(u, 0.0) * N.fix_t(v, 0.0),
                       definedonelements=hn)
    a += N.SymbolicFacetPatchBFI(form=0.1 / (h * h) * (u - u.Other())
                                 * (v - v.Other()), time_order=1,
                                 definedonelements=band)
    a += N.SymbolicBFI(form=N.tref * (u - u.Other()) * (v - v.Other()),
                       skeleton=True, time_order=2)
    a += N.SymbolicBFI(form=(1 + N.tref) * u * v, element_boundary=True,
                       time_order=2)
    a += N.SymbolicBFI(form=N.tref * u * v, VOL_or_BND=N.BND, time_order=2)
    a += N.SymbolicBFI(form=N.fix_t(N.dt(u), 0.0) * N.fix_t(v, 1.0))
    a.Assemble()
    uold = N.GridFunction(Vh)
    uold.Set(N.x * N.y + 1)
    f = N.LinearForm(W)
    f += N.SymbolicLFI(dom, form=N.sin(N.x + N.tref) * v, time_order=3,
                       definedonelements=hn)
    f += N.SymbolicLFI({"levelset": lbot, "domain_type": N.NEG},
                       form=uold * N.fix_t(v, 0.0), definedonelements=hn)
    f += N.SymbolicLFI(form=N.tref * N.x * v, VOL_or_BND=N.BND, time_order=2)
    f += N.SymbolicLFI(form=N.tref * v, time_order=1)
    f.Assemble()
    return a, f


def test_dg_forms_match_jax():
    (aj, fj), (at, ft) = _dg_forms(J, {}), _dg_forms(T, CPU)
    _close(at.mat.todense(), np.asarray(aj.mat.todense()))
    _close(ft.vec.data, np.asarray(fj.vec.data))


def _pg_forms(N, kw, nx=5):
    """The Petrov-Galerkin blocks of the CG-in-time heat example."""
    mesh = N.MakeStructured2DMesh(
        quads=False, nx=nx, ny=nx, mapping=lambda a, b: (2 * a - 1, 2 * b - 1))
    fes1 = N.H1(mesh, order=1, dgjumps=True, **kw)
    W_i = N.SpaceTimeFESpace(fes1, N.ScalarTimeFE(1, skip_first_node=True))
    W_e = N.SpaceTimeFESpace(fes1, N.ScalarTimeFE(1, only_first_node=True))
    W_t = N.SpaceTimeFESpace(fes1, N.ScalarTimeFE(0))
    lset = _st_lset(N, kw, mesh, 1, lambda M: M.sqrt(
        M.x * M.x + (M.y - 0.2 * M.tref) ** 2) - 0.5)
    dom = {"levelset": lset, "domain_type": N.NEG}
    v_t = W_t.TestFunction()
    w = N.CoefficientFunction((0.0, 0.3))
    h = N.specialcf.mesh_size
    mats = []
    for W_u in (W_i, W_e):
        u = W_u.TrialFunction()
        a = N.BilinearForm(trialspace=W_u, testspace=W_t)
        a += N.SymbolicBFI(dom, form=-u * N.dt(v_t), time_order=2)
        a += N.SymbolicBFI(dom, form=-0.1 * u * N.InnerProduct(w, N.grad(v_t))
                           + 0.1 * N.grad(u) * N.grad(v_t), time_order=2)
        a += N.SymbolicFacetPatchBFI(form=0.1 / (h * h) * (u - u.Other())
                                     * (v_t - v_t.Other()), time_order=2)
        a += N.SymbolicBFI(form=N.fix_t(u, 1.0) * N.fix_t(v_t, 1.0))
        a.Assemble()
        assert a.mat.shape == (W_t.ndof, W_u.ndof)
        mats.append(a.mat.todense())
    return mats


def test_petrov_galerkin_forms_match_jax():
    for a, b in zip(_pg_forms(T, CPU), _pg_forms(J, {})):
        _close(a, np.asarray(b))


def _deform_forms(N, kw, nx=5):
    """One slab of ``moving_domain(deform=True)``'s forms: the space-time
    deformation of ``LevelSetMeshAdaptation_Spacetime`` in the volume and
    facet-patch integrals, and ``dt(deform_st)`` in the integrand; and a
    space-time ``Integrate`` under that deformation."""
    mesh = N.MakeStructured2DMesh(
        quads=False, nx=nx, ny=nx, mapping=lambda a, b: (2 * a - 1, 2 * b - 1))
    lsa = N.LevelSetMeshAdaptation_Spacetime(mesh, order_space=2,
                                             order_time=1, threshold=0.5, **kw)
    levelset = N.sqrt((N.x + 0.2 - 0.25 * N.tref) ** 2 + N.y * N.y) - 0.5
    deform = lsa.CalcDeformation(levelset)
    W = N.SpaceTimeFESpace(N.H1(mesh, order=2, dgjumps=True, **kw),
                           N.ScalarTimeFE(1))
    u, v = W.TnT()
    h = N.specialcf.mesh_size
    dom = {"levelset": lsa.lset_p1, "domain_type": N.NEG}
    a = N.BilinearForm(W)
    a += N.SymbolicBFI(dom, form=(N.dt(u) - N.InnerProduct(N.dt(deform),
                                                           N.grad(u))) * v
                       + 0.1 * N.grad(u) * N.grad(v), time_order=3,
                       deformation=deform)
    a += N.SymbolicFacetPatchBFI(form=0.1 / (h * h) * (u - u.Other())
                                 * (v - v.Other()), time_order=1,
                                 deformation=deform,
                                 definedonelements=lsa.hasif_spacetime.np[
                                     mesh.facet2el_np[:, 0]]
                                 & (mesh.facet2el_np[:, 1] >= 0))
    a.Assemble()
    f = N.LinearForm(W)
    f += N.SymbolicLFI(dom, form=N.cos(N.y + N.tref) * v, time_order=3,
                       deformation=deform)
    f.Assemble()
    vol = N.Integrate(dom, 1 + N.x * N.tref, mesh, order=3, time_order=3,
                      deformation=deform)
    return (deform.vec.data, a.mat.todense(), f.vec.data,
            lsa.CalcMaxDistance(levelset), vol)


def test_spacetime_deformation_forms_match_jax():
    got, ref = _deform_forms(T, CPU), _deform_forms(J, {})
    assert np.abs(_np(got[0]) - np.asarray(ref[0])).max() <= 1e-12
    assert np.abs(_np(got[0])).max() > 1e-4
    _close(got[1], np.asarray(ref[1]))
    _close(got[2], np.asarray(ref[2]))
    assert abs(got[3] - ref[3]) <= 1e-12 * max(abs(ref[3]), 1e-3)
    assert abs(got[4] - ref[4]) <= 1e-12 * abs(ref[4])


# -- the reference's space-time test contracts on the port ----------------------

def test_st_moving_circle_eoc():
    r = 0.5
    errs = []
    for i in range(2):
        nx, nslab = 8 * 2**i, 2 * 2**i
        mesh = T.MakeStructured2DMesh(
            quads=False, nx=nx, ny=nx, mapping=lambda a, b: (2 * a - 1, 2 * b - 1))
        st = T.SpaceTimeFESpace(T.H1(mesh, order=1, **CPU), T.ScalarTimeFE(1))
        lset = T.GridFunction(st)
        tot = 0.0
        for s in range(nslab):
            t0, dts = s / nslab, 1.0 / nslab
            lev = T.sqrt((T.x - 0.2 * (t0 + dts * T.tref) + 0.1) ** 2
                         + T.y * T.y) - r
            T.SpaceTimeInterpolateToP1(lev, T.tref, lset)
            tot += dts * T.Integrate({"levelset": lset, "domain_type": T.NEG},
                                     T.CoefficientFunction(1.0), mesh,
                                     order=2, time_order=2)
        errs.append(abs(tot - pi * r * r))
    eoc = mlog(errs[0] / errs[1]) / mlog(2)
    assert eoc > 1.7, (errs, eoc)


def _sphere_st_error(n_steps, i, dim):
    if dim == 2:
        mesh = T.MakeStructured2DMesh(
            quads=False, nx=2**i, ny=2**i,
            mapping=lambda a, b: (2 * a - 1, 2 * b - 1))
        rr = T.x**2 + T.y**2
    else:
        mesh = T.MakeStructured3DMesh(
            hexes=False, nx=2**i, ny=2**i, nz=2**i,
            mapping=lambda a, b, c: (2 * a - 1, 2 * b - 1, 2 * c - 1))
        rr = T.x**2 + T.y**2 + T.z**2
    r0 = 0.9
    st = T.SpaceTimeFESpace(T.H1(mesh, order=1, **CPU), T.ScalarTimeFE(1))
    lset_p1 = T.GridFunction(st)
    delta_t = 1.0 / n_steps
    sum_vol = sum_int = 0.0
    for s in range(n_steps):
        t_abs = s * delta_t + delta_t * T.tref
        T.SpaceTimeInterpolateToP1(T.sqrt(rr + t_abs * t_abs) - r0, T.tref,
                                   lset_p1)
        sum_vol += delta_t * T.Integrate(
            {"levelset": lset_p1, "domain_type": T.NEG},
            T.CoefficientFunction(1.0), mesh, time_order=1)
        sum_int += delta_t * T.Integrate(
            {"levelset": lset_p1, "domain_type": T.IF},
            T.CoefficientFunction(1.0), mesh, time_order=1)
    if dim == 2:
        return (abs(sum_vol - 2.0 / 3 * pi * r0**3),
                abs(sum_int - 0.5 * pi**2 * r0**2))
    return (abs(sum_vol - pi**2 / 4 * r0**4),
            abs(sum_int - 8.0 / 3 * pi * r0**3))


def test_spacetime_area_of_a_sphere():
    errs = [_sphere_st_error(2**(i + 2), i + 1, 2) for i in range(3)]
    for k in (0, 1):
        e = [x[k] for x in errs]
        eocs = [mlog(e[i - 1] / e[i]) / mlog(2) for i in (1, 2)]
        assert sum(eocs) / 2 > 1.75, (e, eocs)


def test_spacetime_area_of_a_hypersphere():
    errs = [_sphere_st_error(2**(i + 3), i + 2, 3) for i in range(2)]
    for k in (0, 1):
        eoc = mlog(errs[0][k] / errs[1][k]) / mlog(2)
        assert eoc > 1.7, (errs, eoc)


def test_spacetime_quad_mesh_eoc():
    def vol(nx, nsteps):
        mesh = T.MakeStructured2DMesh(quads=True, nx=nx, ny=nx)
        st = T.SpaceTimeFESpace(T.H1(mesh, order=1, **CPU), T.ScalarTimeFE(1))
        tot = 0.0
        for k in range(nsteps):
            t0, t1 = k / nsteps, (k + 1) / nsteps
            lset = T.GridFunction(st)
            phi = T.sqrt((T.x - (0.4 + 0.2 * (t0 + (t1 - t0) * T.tref))) ** 2
                         + (T.y - 0.5) ** 2) - 0.25
            T.SpaceTimeInterpolateToP1(phi, T.tref, lset)
            tot += T.Integrate({"levelset": lset, "domain_type": T.NEG},
                               T.CoefficientFunction(1.0), mesh, order=2,
                               time_order=2) * (t1 - t0)
        return tot

    exact = np.pi * 0.25 ** 2
    errs = [abs(vol(nx, nx) - exact) for nx in (8, 16)]
    assert np.log2(errs[0] / errs[1]) > 1.75, errs


def test_rectangular_petrov_galerkin_assembly():
    mesh = T.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    Vs = T.H1(mesh, order=1, **CPU)
    W_i = T.SpaceTimeFESpace(Vs, T.ScalarTimeFE(1, skip_first_node=True))
    W_e = T.SpaceTimeFESpace(Vs, T.ScalarTimeFE(1, only_first_node=True))
    W_t = T.SpaceTimeFESpace(Vs, T.ScalarTimeFE(0))
    u_i, u_e, v_t = W_i.TrialFunction(), W_e.TrialFunction(), W_t.TestFunction()
    u, v = Vs.TnT()
    m = T.BilinearForm(Vs)
    m += T.SymbolicBFI(form=u * v)
    m.Assemble()
    M = _np(m.mat.todense())
    a = T.BilinearForm(trialspace=W_i, testspace=W_t)
    a += T.SymbolicBFI(form=T.dt(u_i) * v_t, time_order=2)
    a.Assemble()
    assert a.mat.shape == (W_t.ndof, W_i.ndof)
    assert np.abs(_np(a.mat.todense()) - M).max() < 1e-12
    ae = T.BilinearForm(trialspace=W_e, testspace=W_t)
    ae += T.SymbolicBFI(form=T.dt(u_e) * v_t, time_order=2)
    ae.Assemble()
    assert np.abs(_np(ae.mat.todense()) + M).max() < 1e-12
    bad = T.BilinearForm(trialspace=W_i, testspace=W_t)
    bad += T.SymbolicBFI(form=T.dt(u_e) * v_t, time_order=2)
    with pytest.raises(ValueError, match="trial"):
        bad.Assemble()


def test_cg_in_time_variants():
    mesh = T.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    Vs = T.H1(mesh, order=1, **CPU)
    W = T.SpaceTimeFESpace(Vs, T.ScalarTimeFE(1, skip_first_node=True))
    assert W.ndof == Vs.ndof
    assert not W.IsTimeNodeActive(0) and W.IsTimeNodeActive(1)
    u, v = W.TnT()
    a = T.BilinearForm(W)
    a += T.SymbolicBFI(form=T.dt(u) * v, time_order=2)
    a.Assemble()
    f = T.LinearForm(W)
    f += T.SymbolicLFI(form=T.CoefficientFunction(1.0) * v, time_order=2)
    f.Assemble()
    gfu = T.GridFunction(W)
    gfu.vec.data = a.mat.Inverse() * f.vec.data
    u1 = T.GridFunction(Vs)
    T.RestrictGFInTime(gfu, 1.0, u1)
    assert np.abs(u1.vec.NumPy() - 1.0).max() < 1e-12
    T.RestrictGFInTime(gfu, 0.0, u1)
    assert np.abs(u1.vec.NumPy()).max() < 1e-12
    Wo = T.SpaceTimeFESpace(Vs, T.ScalarTimeFE(2, only_first_node=True))
    assert Wo.ndof == Vs.ndof
    assert Wo.IsTimeNodeActive(0) and not Wo.IsTimeNodeActive(1)


def test_spacetime_gridfunction_set():
    mesh = T.MakeStructured2DMesh(quads=False, nx=4, ny=4)
    for kw in ({}, {"skip_first_node": True}, {"only_first_node": True}):
        st = T.SpaceTimeFESpace(T.H1(mesh, order=2, **CPU),
                                T.ScalarTimeFE(2, **kw))
        gf = T.GridFunction(st)
        gf.Set(T.x + T.tref)
        for t in st.tfe.nodes:
            gs = T.CreateTimeRestrictedGF(gf, float(t))
            avg = T.Integrate(cf=gs, mesh=mesh, order=4, **CPU)
            assert abs(avg - (0.5 + float(t))) < 1e-12, (kw, t, avg)


def test_spacetime_pitfalls_and_operators():
    """The time-context errors of the reference's pitfall test; dt/fix_t
    composition (``dt(grad(u))`` raises, ``fix_t(dt(u))`` assembles the
    Kronecker product); the own ``dirichlet=``; SetTime; TimeFixedCF keeps
    a context's deformation."""
    from ngsxfem_tpu_torch.cf.context import EvalCtx, eval_pure

    mesh = T.MakeStructured2DMesh(quads=False, nx=4, ny=4)
    fes1 = T.H1(mesh, order=1, dirichlet=[1, 2, 3, 4], **CPU)
    st_fes = T.SpaceTimeFESpace(fes1, T.ScalarTimeFE(1))
    t = T.Parameter(0) + 0.1 * T.tref
    gf = T.GridFunction(fes1)
    with pytest.raises(ValueError, match="time context"):
        gf.Set(T.sin(pi * t) * T.x)
    v = st_fes.TestFunction()
    f = T.LinearForm(st_fes)
    f += T.SymbolicLFI(form=gf * v)
    with pytest.raises(ValueError, match="time context"):
        f.Assemble()
    with pytest.raises(ValueError, match="time context"):
        T.Integrate((T.sin(pi * t) * T.x) ** 2, mesh, order=2, **CPU)

    mesh = T.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    Vs = T.H1(mesh, order=1, **CPU)
    W = T.SpaceTimeFESpace(Vs, T.ScalarTimeFE(1))
    u, v = W.TnT()
    with pytest.raises(NotImplementedError):
        T.dt(T.grad(u))
    with pytest.raises(NotImplementedError):
        T.dt(T.dt(u))
    assert T.fix_t(T.grad(u), 0.0).op == "fixtgrad"
    a = T.BilinearForm(W)
    a += T.SymbolicBFI(form=T.fix_t(T.dt(u), 0.0) * T.fix_t(v, 0.0))
    a.Assemble()
    us, vs = Vs.TnT()
    m = T.BilinearForm(Vs)
    m += T.SymbolicBFI(form=us * vs)
    m.Assemble()
    expected = np.kron(np.outer([1.0, 0.0], [-1.0, 1.0]), _np(m.mat.todense()))
    assert np.abs(_np(a.mat.todense()) - expected).max() < 1e-12

    Wd = T.SpaceTimeFESpace(T.H1(mesh, order=1, **CPU), T.ScalarTimeFE(1),
                            dirichlet=[1, 2, 3, 4])
    ref = T.H1(mesh, order=1, dirichlet=[1, 2, 3, 4], **CPU)
    assert np.array_equal(Wd.dirichlet_dofs, np.tile(ref.dirichlet_dofs, 2))
    assert np.array_equal(~Wd.FreeDofs().np, np.tile(ref.dirichlet_dofs, 2))

    g = T.GridFunction(W)
    T.SpaceTimeInterpolateToP1(T.x + T.tref, T.tref, g)
    with pytest.raises(ValueError):
        T.Integrate(cf=g, mesh=mesh, order=2, **CPU)
    W.SetTime(0.25)
    assert abs(T.Integrate(cf=g, mesh=mesh, order=2, **CPU) - 0.75) < 1e-12
    W.SetTime(0.5)
    assert abs(T.Integrate(cf=g, mesh=mesh, order=2, **CPU) - 1.0) < 1e-12
    W.SetTime(None)

    deform = T.GridFunction(T.VectorH1(mesh, order=1, **CPU))
    deform.Set(T.CoefficientFunction((0.25 * T.x, 0.0 * T.y)))
    ref_pts = torch.tensor([[[0.2, 0.3]]], dtype=torch.float64)
    ctx = EvalCtx(mesh, ref_pts, deformation=deform,
                  time=torch.zeros((mesh.ne, 1), dtype=torch.float64))
    got = eval_pure(T.fix_t(T.x + 0.0 * T.tref, 0.5), ctx)
    assert torch.allclose(got, ctx.phys[..., 0], atol=1e-12)


def test_spacetime_model_spacetime():
    """Reference ``test_spacetime_model_spacetime``: the fitted heat
    equation through the space-time cut integrators (all-NEG dummy level
    set), DG(1) in time, 32 steps; per-step L2 error < 5e-3, final < 2e-4."""
    mesh = T.MakeStructured2DMesh(quads=False, nx=32, ny=32)
    fes1 = T.H1(mesh, order=1, dirichlet=[1, 2, 3, 4], **CPU)
    st_fes = T.SpaceTimeFESpace(fes1, T.ScalarTimeFE(1))
    delta_t = 1 / 32
    told = T.Parameter(0)
    t = told + delta_t * T.tref
    x, y, sin, cos = T.x, T.y, T.sin, T.cos
    u_exact = lambda tv: T.CoefficientFunction(
        sin(pi * tv) * sin(pi * x) * sin(pi * x) * sin(pi * y) * sin(pi * y))
    coeff_f = T.CoefficientFunction(
        pi * cos(pi * t) * sin(pi * x) * sin(pi * x) * sin(pi * y) * sin(pi * y)
        - 2 * pi * pi * sin(pi * t) * (
            cos(pi * x) * cos(pi * x) * sin(pi * y) * sin(pi * y)
            - sin(pi * x) * sin(pi * x) * sin(pi * y) * sin(pi * y)
            + cos(pi * y) * cos(pi * y) * sin(pi * x) * sin(pi * x)
            - sin(pi * x) * sin(pi * x) * sin(pi * y) * sin(pi * y)))
    u0 = T.GridFunction(st_fes)
    u0_ic = T.GridFunction(fes1)
    u, v = st_fes.TnT()
    lsetp1 = T.GridFunction(T.H1(mesh, order=1, **CPU))
    T.InterpolateToP1(T.sqrt(x * x + y * y) - 1000.5, lsetp1)
    lset_neg = {"levelset": lsetp1, "domain_type": T.NEG, "subdivlvl": 0}
    a = T.BilinearForm(st_fes)
    a += T.SymbolicBFI(levelset_domain=lset_neg,
                       form=delta_t * T.grad(u) * T.grad(v), time_order=2)
    a += T.SymbolicBFI(form=T.fix_t(u, 0) * T.fix_t(v, 0))
    a += T.SymbolicBFI(levelset_domain=lset_neg, form=T.dt(u) * v,
                       time_order=2)
    a.Assemble()
    f = T.LinearForm(st_fes)
    f += T.SymbolicLFI(levelset_domain=lset_neg,
                       form=delta_t * coeff_f * v, time_order=2)
    f += T.SymbolicLFI(form=u0_ic * T.fix_t(v, 0))
    t_old = 0
    u0_ic.Set(u_exact(0))
    inv = a.mat.Inverse(st_fes.FreeDofs())
    while 1.0 - t_old > delta_t / 2:
        f.Assemble()
        u0.vec.data = inv * f.vec
        u0_ic.vec[:] = u0.vec[fes1.ndof: 2 * fes1.ndof]
        t_old = t_old + delta_t
        told.Set(t_old)
        l2error = msqrt(T.Integrate((u_exact(t_old) - u0_ic) ** 2, mesh,
                                    order=6, **CPU))
        assert l2error < 5e-3, (t_old, l2error)
    assert l2error < 2e-4, l2error


# -- the examples ---------------------------------------------------------------

def _example(name):
    import importlib
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    return (importlib.import_module(f"examples.{name}"),
            importlib.import_module(f"ngsxfem_tpu_torch.examples.{name}"))


def _rel(a, b):
    return abs(a - b) <= 1e-9 * abs(b)


def test_moving_domain_example():
    """Parity with the JAX example at nx=12, and the reference test's
    convergence (the error halves from nx=12/4 slabs to nx=24/8)."""
    jm, tm = _example("moving_domain")
    e1 = tm.run(nx=12, nslab=4, verbose=False, **CPU)
    assert _rel(e1, jm.run(nx=12, nslab=4, verbose=False)), e1
    e2 = tm.run(nx=24, nslab=8, verbose=False, **CPU)
    assert e2 < e1 / 2, (e1, e2)


def test_moving_domain_deformed_example():
    jm, tm = _example("moving_domain")
    kw = dict(nx=8, nslab=2, order=2, deform=True, verbose=False)
    e = tm.run(**kw, **CPU)
    assert _rel(e, jm.run(**kw)) and e < 0.1, e


def test_heateq_cg_spacetime_example():
    jm, tm = _example("heateq_cg_spacetime")
    e1 = tm.run(nx=12, nslab=8, tend=0.25, verbose=False, **CPU)
    ej = jm.run(nx=12, nslab=8, tend=0.25, verbose=False)
    assert all(_rel(a, b) for a, b in zip(e1, ej)), (e1, ej)
    e2 = tm.run(nx=24, nslab=16, tend=0.25, verbose=False, **CPU)[-1]
    assert e2 < e1[-1] / 2, (e1[-1], e2)


def test_moving_domain3d_example():
    """Parity with the JAX example at its test's smaller size (its halving
    to nx=12, nslab=4, costly on a CPU shared by test workers, runs on the
    card in chip_smoke.py phase 20)."""
    jm, tm = _example("moving_domain3d")
    e1 = tm.run(nx=6, nslab=2, verbose=False, **CPU)
    assert _rel(e1, jm.run(nx=6, nslab=2, verbose=False)), e1


def test_chip_smoke_spacetime_phases_on_cpu(monkeypatch):
    """The checks of chip_smoke.py's phases 20-21 on the CPU (as both the
    "card" and the host) at small sizes, each a doubling: card-vs-CPU
    parity of the rule and the examples, the halving rule, the per-slab
    clock (every slab solve the host LU, the Petrov-Galerkin shapes), and
    the clock puts every method back.  Both phases run moving_domain and
    heateq here (the 3D and deformed runs take the same code)."""
    import chip_smoke as cs
    from ngsxfem_tpu_torch.forms import assemble

    for name, val in (("ST_RULE_NX", 6), ("ST_MD", ((6, 2), (12, 4))),
                      ("ST_HEAT", ((6, 4), (12, 8))),
                      ("ST_3D", ()), ("ST_DEF", ()),
                      ("ST_MD_BIG", ((24, 8), (48, 16))),
                      ("ST_HEAT_BIG", ((12, 4), (24, 8))),
                      ("ST_3D_BIG", ()),
                      ("ST_DEF_BIG", ())):
        monkeypatch.setattr(cs, name, val)
    dev = torch.device("cpu")
    vals, rel, dr, nif = cs.st_rule_parity(T, dev)
    assert rel == 0.0 and dr == 0.0 and nif > 0
    orig = assemble.BilinearForm.Assemble
    par = cs.st_parity(T, dev)
    big = cs.st_card(T, dev, par)
    assert assemble.BilinearForm.Assemble is orig
    heat = big["heateq_cg_spacetime"][0]
    assert heat["clock"].rect and all(a == b for a, b in heat["clock"].rect)
    for rows in big.values():
        for r in rows:
            sp = r["clock"].split()
            # one slab solve each; the deformed example's adaptation runs
            # a CutInfo of its own per slab
            assert sp["solve"][2] == r["nslab"] <= sp["cutinfo"][2]
            assert sp["bfi"][2] >= r["nslab"] and sp["lu"][1] > 0
