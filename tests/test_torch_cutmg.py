"""General cut multigrid of the PyTorch port against the JAX package.

The setups of ``tests/test_cutmg_api.py`` and ``tests/test_multigrid.py``
(the Nitsche + ghost-penalty fictitious-domain system of the circle r=0.6
on [-1, 1]^2 trigs, order 1 and 2) go through both packages, tensors on
the CPU in float64: the patch builders give the same blocks;
``_prepare_blocks`` the same ``idx``, ``valid`` and ``scale`` exactly and
the block inverses to 1e-10 relative; one ``CutFemSmoother.smooth`` and one
V-cycle of ``MultiGridCL`` on a seeded vector to 1e-10 relative;
``examples.cutmg`` MG-CG (2D nx0=8 and 3D nx0=2, two levels) within one
iteration of the JAX package and its solution to 1e-8; ``P2TwoGridCL`` on
the nx=8 P2 problem in the same iterations with the solution to 1e-8; the
prolongation classes and ``CompoundProlongation`` to 1e-14.  The cases of
``tests/test_cutmg_api.py`` and the limits of ``tests/test_multigrid.py``
(but its 103k-dof scale case) run on the port.
"""
import os
import sys
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu.solvers import mg as jmg
from ngsxfem_tpu_torch.solvers import mg as tmg

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CPU = {"device": "cpu"}
PKGS = ((J, {}), (T, CPU))
_CACHE = {}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _np(v):
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _sq_mesh(N, nx):
    return N.MakeStructured2DMesh(quads=False, nx=nx, ny=nx,
                                  mapping=lambda a, b: (2 * a - 1, 2 * b - 1))


def _cut_problem(N, nx, order):
    """tests/test_cutmg_api.py's system on nx x nx trigs, built once per
    package: (mesh, Vh, ci, A, b, active)."""
    key = (N.__name__, nx, order)
    if key in _CACHE:
        return _CACHE[key]
    kw = CPU if N is T else {}
    mesh = _sq_mesh(N, nx)
    levelset = N.sqrt(N.x * N.x + N.y * N.y) - 0.6
    lsetp1 = N.GridFunction(N.H1(mesh, order=1, **kw))
    N.InterpolateToP1(levelset, lsetp1)
    ci = N.CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(N.HASNEG)
    hasif = ci.GetElementsOfType(N.IF)
    Vh = N.H1(mesh, order=order, dgjumps=True, **kw)
    ba_facets = N.GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif)
    h = N.specialcf.mesh_size
    n_lset = 1.0 / N.Norm(N.grad(lsetp1)) * N.grad(lsetp1)
    u, v = Vh.TnT()
    lset_neg = {"levelset": lsetp1, "domain_type": N.NEG}
    lset_if = {"levelset": lsetp1, "domain_type": N.IF}
    a = N.BilinearForm(Vh)
    a += N.SymbolicBFI(lset_neg, form=N.grad(u) * N.grad(v),
                       definedonelements=hasneg)
    a += N.SymbolicBFI(lset_if, form=-(N.grad(u) * n_lset) * v
                       - (N.grad(v) * n_lset) * u
                       + 20.0 * order * order / h * u * v)
    a += N.SymbolicFacetPatchBFI(
        form=0.5 / (h * h) * (u - u.Other()) * (v - v.Other()),
        definedonelements=ba_facets)
    a.Assemble()
    f = N.LinearForm(Vh)
    f += N.SymbolicLFI(lset_neg, form=N.CoefficientFunction(1.0) * v,
                       definedonelements=hasneg)
    f.Assemble()
    active = N.GetDofsOfElements(Vh, hasneg)
    _CACHE[key] = (mesh, Vh, ci, a.mat, f._vec, active)
    return _CACHE[key]


def _blocks(N, Vh, mesh, kind):
    mod = jmg if N is J else tmg
    if kind == "vert":
        return mod.VertPatches(Vh, mesh)
    if kind == "elem":
        return mod.ElemPatches(Vh)
    return mod.EdgePatches(Vh, mesh)


@pytest.mark.parametrize("kind", ["vert", "elem", "edge"])
def test_patches_match_reference_and_cover_free_dofs(kind):
    """The same blocks in the same order as the JAX package's, and
    (tests/test_cutmg_api.py) every free dof lies in some block."""
    got = {}
    for N, _ in PKGS:
        mesh, Vh, *_ = _cut_problem(N, 6, 2)
        got[N] = _blocks(N, Vh, mesh, kind)
    assert len(got[T]) == len(got[J])
    for bt, bj in zip(got[T], got[J]):
        assert bt.dtype == bj.dtype and np.array_equal(bt, bj)
    _, Vh, *_ = _cut_problem(T, 6, 2)
    cover = np.zeros(Vh.ndof, bool)
    cover[np.concatenate(got[T])] = True
    assert cover[np.asarray(Vh.FreeDofs().np)].all()


@pytest.mark.parametrize("kind", ["edge", "vert"])
def test_prepare_blocks_match_reference(kind):
    """Batched block setup == the reference's per-patch loop: idx, valid
    and scale exactly, the f64 inverses to 1e-10 relative; restricted to
    the active dofs, as P2TwoGridCL's smoother sees them."""
    out = {}
    for N, _ in PKGS:
        mesh, Vh, _, A, _, active = _cut_problem(N, 6, 2)
        free = np.asarray(active.np)
        mod = jmg if N is J else tmg
        out[N] = [_np(a) for a in mod._prepare_blocks(
            A, _blocks(N, Vh, mesh, kind), free)]
    (it, inv_t, vt, st), (ij, inv_j, vj, sj) = out[T], out[J]
    assert np.array_equal(it, ij) and np.array_equal(vt, vj)
    assert np.array_equal(st, sj)
    assert _rel(inv_t, inv_j) <= 1e-10
    per_block = (np.linalg.norm(inv_t - inv_j, axis=(1, 2))
                 / np.linalg.norm(inv_j, axis=(1, 2)))
    assert per_block.max() <= 1e-10


def test_prepare_blocks_singular_uses_pinv():
    """A singular block goes through ``pinv`` (the reference's fallback):
    the block of two dofs of an all-ones 2 x 2 coupling."""
    A = T.SparseMatrix([0, 0, 1, 1, 2], [0, 1, 0, 1, 2],
                       torch.tensor([1.0, 1.0, 1.0, 1.0, 2.0],
                                    dtype=torch.float64), (3, 3), **CPU)
    stats = {}
    idx, inv, valid, scale = tmg._prepare_blocks(
        A, [np.array([0, 1]), np.array([2])], np.ones(3, bool), stats)
    assert stats == {"nb": 2, "K": 2, "pinv": 1}
    assert np.allclose(inv[0].numpy(), np.full((2, 2), 0.25))
    assert inv[1, 0, 0] == 0.5 and not valid[1, 1]
    assert torch.equal(scale, torch.ones(3, dtype=torch.float64))


@pytest.mark.parametrize("mode", ["blocks", "jacobi_if"])
def test_smooth_matches_reference(mode):
    """One ``smooth()`` (two steps) from zero on the masked load: patch
    blocks (edge) on the P2 system, or damped Jacobi + the interface-block
    CG (``if_tol`` 1e-4) on the P1 system the V-cycle smooths (nx=16).  On
    the P2 system that inner CG is sensitive to rounding in the JAX package
    itself: its iterate moves by 1.2e-7 relative when its input is scaled by
    1 + 1e-15."""
    xs = {}
    for N, _ in PKGS:
        mesh, Vh, ci, A, b, active = (_cut_problem(N, 6, 2) if mode == "blocks"
                                      else _cut_problem(N, 16, 1))
        mod = jmg if N is J else tmg
        fm = np.asarray(active.np)
        if mode == "blocks":
            sm = mod.CutFemSmoother(A, freedofs=active,
                                    blocks=_blocks(N, Vh, mesh, "edge"),
                                    if_correction=False)
        else:
            ifd = N.GetDofsOfElements(Vh, ci.GetElementsOfType(N.IF))
            sm = mod.CutFemSmoother(A, freedofs=active, if_dofs=ifd)
        bm = np.where(fm, _np(b), 0.0)
        if N is J:
            x = sm.smooth(jnp.zeros_like(jnp.asarray(bm)), jnp.asarray(bm))
        else:
            bt = torch.as_tensor(bm)
            x = sm.smooth(torch.zeros_like(bt), bt)
        xs[N] = _np(x)
    assert _rel(xs[T], xs[J]) <= 1e-10


def test_block_smoother_reduces_residual():
    """tests/test_cutmg_api.py::test_block_smoother_reduces_residual on the
    port; two smoothings are bitwise equal."""
    mesh, Vh, _, A, b, active = _cut_problem(T, 6, 2)
    sm = T.CutFemSmoother(A, freedofs=active, blocks=T.EdgePatches(Vh, mesh),
                          if_correction=False)
    fm = torch.as_tensor(active.np)
    bm = torch.where(fm, b, 0.0)
    x = sm.smooth(torch.zeros_like(bm), bm, steps=6)
    assert torch.equal(x, sm.smooth(torch.zeros_like(bm), bm, steps=6))
    r0 = float(torch.linalg.vector_norm(bm))
    r = float(torch.linalg.vector_norm(torch.where(fm, bm - A.matvec(x),
                                                   0.0)))
    assert r < 0.5 * r0, (r, r0)


def _mg(N, nxs):
    """``MultiGridCL`` over examples/cutmg.py's levels nx in ``nxs``."""
    from ngsxfem_tpu_torch.examples import cutmg as tc
    from examples import cutmg as jc

    key = (N.__name__, "mg", nxs)
    if key not in _CACHE:
        mod = jmg if N is J else tmg
        meshes = [_sq_mesh(N, nx) for nx in nxs]
        lv = [tc.build_level(m, 1, "cpu") if N is T else jc.build_level(m, 1)
              for m in meshes]
        kw = CPU if N is T else {}
        prols = [mod.prolongation_matrix(lv[l][0], lv[l + 1][0], **kw)
                 for l in range(len(nxs) - 1)]
        sms = [None] + [mod.CutFemSmoother(lv[l][1], freedofs=lv[l][3],
                                           if_dofs=lv[l][4])
                        for l in range(1, len(nxs))]
        mgp = mod.MultiGridCL([v[1] for v in lv], prols, sms,
                              coarse_freedofs=lv[0][3])
        _CACHE[key] = (mgp, lv)
    return _CACHE[key]


def test_vcycle_matches_reference():
    """One V-cycle (nx 4 -> 8 -> 16, f64) on a seeded vector."""
    z = {}
    for N, _ in PKGS:
        mgp, lv = _mg(N, (4, 8, 16))
        b = np.random.default_rng(7).standard_normal(lv[-1][1].shape[0])
        b = np.where(np.asarray(lv[-1][3].np), b, 0.0)
        z[N] = _np(mgp(jnp.asarray(b) if N is J else torch.as_tensor(b)))
    assert _rel(z[T], z[J]) <= 1e-10


def _jax_cutmg(nx0, levels, dim):
    """examples/cutmg.py's run, keeping the MG-CG solution."""
    from examples import cutmg as jc
    from ngsxfem_tpu.solvers.krylov import cg, masked_matvec

    meshes = jc_meshes(nx0, levels, dim)
    lv = [jc.build_level(m, 1) for m in meshes]
    prols = [jmg.prolongation_matrix(lv[l][0], lv[l + 1][0])
             for l in range(levels - 1)]
    sms = [None] + [jmg.CutFemSmoother(lv[l][1], freedofs=lv[l][3],
                                       if_dofs=lv[l][4])
                    for l in range(1, levels)]
    mgp = jmg.MultiGridCL([v[1] for v in lv], prols, sms,
                          coarse_freedofs=lv[0][3])
    A, b = lv[-1][1], lv[-1][2]
    fm = jnp.asarray(lv[-1][3].np)
    x, it, _ = cg(masked_matvec(A.matvec, fm), jnp.where(fm, b, 0.0),
                  M=lambda r: jnp.where(fm, mgp(r), r), maxiter=100,
                  tol=1e-8)
    return np.asarray(x), int(it)


def jc_meshes(nx0, levels, dim):
    if dim == 2:
        return [_sq_mesh(J, nx0 * 2**l) for l in range(levels)]
    return [J.MakeStructured3DMesh(hexes=False, nx=nx0 * 2**l,
                                   ny=nx0 * 2**l, nz=nx0 * 2**l,
                                   mapping=lambda a, b, c:
                                   (2 * a - 1, 2 * b - 1, 2 * c - 1))
            for l in range(levels)]


@pytest.mark.parametrize("dim,nx0", [(2, 8), (3, 2)])
def test_cutmg_example_matches_reference(dim, nx0):
    """``examples.cutmg.run`` (two levels): MG-CG iterations within one of
    the JAX package's, the solution to 1e-8, the JAX test's limits."""
    from ngsxfem_tpu_torch.examples import cutmg as tc

    stats = {}
    it_mg, it_j, diff = tc.run(nx0=nx0, levels=2, dim=dim, verbose=False,
                               stats=stats, **CPU)
    xj, itj = _jax_cutmg(nx0, 2, dim)
    assert abs(it_mg - itj) <= 1
    assert _rel(_np(stats["x_mg"]), xj) <= 1e-8
    assert diff < 1e-7 and it_mg < it_j / 2, (it_mg, it_j, diff)


def test_cutmg_3d_limits():
    """tests/test_multigrid.py::test_cutmg_3d on the port: nx0=4, three
    levels; MG-CG beats Jacobi-CG by more than 2x; two runs bitwise."""
    from ngsxfem_tpu_torch.examples import cutmg as tc

    s1, s2 = {}, {}
    it_mg, it_j, diff = tc.run(nx0=4, levels=3, dim=3, verbose=False,
                               stats=s1, **CPU)
    assert it_mg * 2 < it_j, (it_mg, it_j)
    assert diff < 1e-6
    x2, it2, _ = s1["mgcg"]()
    assert it2 == it_mg and torch.equal(x2, s1["x_mg"])


def _tg_iters(tg, rhs, capsys):
    """(solution, iterations) of a P2TwoGridCL run with printinfo."""
    tg.printinfo = True
    capsys.readouterr()
    x = tg.Mult(rhs)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("it =")]
    return _np(x), len(lines)


def test_p2twogrid_matches_reference(capsys):
    """tests/test_cutmg_api.py::test_p2twogrid_solves in both packages:
    the same iterations, the solution to 1e-8, r < 1e-6 ||b||; the
    ``usol`` out-parameter receives the solution."""
    res = {}
    for N, kw in PKGS:
        mesh, V2, ci, A2, b2, act2 = _cut_problem(N, 8, 2)
        _, V1, _, A1, _, act1 = _cut_problem(N, 8, 1)
        coarse_inv = A1.Inverse(freedofs=act1)
        mod = jmg if N is J else tmg
        tg = mod.P2TwoGridCL(a=A2, fes=V2, mesh=mesh, ci=ci, ifsolver="cg",
                             linmgiter=lambda r, c=coarse_inv: c * r,
                             coarse_space=V1, patchtype="edge", nu=2,
                             maxit=30, tol=1e-8)
        fm = np.asarray(act2.np)
        tg.free = (jnp.asarray(fm) if N is J else torch.as_tensor(fm))
        res[N] = _tg_iters(tg, b2, capsys)
    (xt, kt), (xj, kj) = res[T], res[J]
    assert kt == kj < 30
    assert _rel(xt, xj) <= 1e-8
    mesh, V2, _, A2, b2, act2 = _cut_problem(T, 8, 2)
    fm = torch.as_tensor(act2.np)
    r = float(torch.linalg.vector_norm(torch.where(
        fm, b2 - A2.matvec(torch.as_tensor(xt)), 0.0)))
    nb = float(torch.linalg.vector_norm(torch.where(fm, b2, 0.0)))
    assert r < 1e-6 * nb, (r, nb)
    _, V1, _, A1, _, act1 = _cut_problem(T, 8, 1)
    tg = T.P2TwoGridCL(a=A2, fes=V2, mesh=mesh, linmgiter=A1.Inverse(act1),
                       coarse_space=V1, nu=2, maxit=3)
    tg.free = fm
    out = torch.zeros(V2.ndof, dtype=torch.float64)
    x = tg.Mult(b2, usol=out)
    assert torch.equal(out, x) and tg.iterations == 3
    with pytest.raises(ValueError, match="patchtype"):
        T.P2TwoGridCL(a=A2, fes=V2, linmgiter=None, patchtype="face")


def test_linear_mg_iterator_solves():
    """``LinearMGIterator`` (MG-CG on the masked system) == the cutmg
    MG-CG solution on the same hierarchy, and a P1 MG iterator drives
    ``P2TwoGridCL`` as the reference's coarse solver."""
    mgp, lv = _mg(T, (4, 8, 16))
    A, b, act = lv[-1][1], lv[-1][2], lv[-1][3]
    it = T.LinearMGIterator(mgp, A, freedofs=act, maxit=50, tol=1e-10)
    x = it * b
    fm = torch.as_tensor(act.np)
    r = torch.where(fm, b - A.matvec(x), 0.0)
    assert float(torch.linalg.vector_norm(r)) <= 1e-9 * float(
        torch.linalg.vector_norm(torch.where(fm, b, 0.0)))


def test_prolongation_classes_match_matrix():
    """tests/test_cutmg_api.py's prolongation cases: the classes against
    the matrix (1e-14) and against the JAX package's classes (1e-14)."""
    res = {}
    for N, kw in PKGS:
        m1, m2 = _sq_mesh(N, 4), _sq_mesh(N, 8)
        V1, V2 = N.H1(m1, order=1, **kw), N.H1(m2, order=1, **kw)
        prol = N.P1Prolongation(m1)
        prol.Update(V1)
        prol.Update(V2)
        xc = np.random.default_rng(0).normal(size=V1.ndof)
        xf = np.random.default_rng(1).normal(size=V2.ndof)
        cast = jnp.asarray if N is J else torch.as_tensor
        mod = jmg if N is J else tmg
        P = mod.prolongation_matrix(V1, V2, **kw)
        out = [_np(prol.Prolongate(1, cast(xc))), _np(prol.Restrict(1, cast(xf))),
               _np(prol.matvec(cast(xc))), _np(prol.T.matvec(cast(xf)))]
        assert _rel(out[0], _np(P.matvec(cast(xc)))) <= 1e-14
        assert _rel(out[1], _np(P.T.matvec(cast(xf)))) <= 1e-14
        assert _rel(out[2], out[0]) <= 1e-14 and _rel(out[3], out[1]) <= 1e-14
        res[N] = out
    for a, b in zip(res[T], res[J]):
        assert _rel(a, b) <= 1e-14
    assert issubclass(T.P2CutProlongation, T.P2Prolongation)


def test_compound_prolongation_reference_style():
    """CompoundProlongation: per-component Prolongate / Restrict / matvec /
    T against the JAX package's (1e-14) and against P per block."""
    res = {}
    for N, kw in PKGS:
        m1, m2 = _sq_mesh(N, 4), _sq_mesh(N, 8)
        W1 = N.FESpace([N.H1(m1, order=1, **kw), N.H1(m1, order=1, **kw)])
        W2 = N.FESpace([N.H1(m2, order=1, **kw), N.H1(m2, order=1, **kw)])
        cp = N.CompoundProlongation(W1)
        cp.AddProlongation(N.P1Prolongation(m1))
        cp.AddProlongation(N.P1Prolongation(m1))
        cp.Update(W1)
        cp.Update(W2)
        cast = jnp.asarray if N is J else torch.as_tensor
        xc = np.random.default_rng(2).normal(size=W1.ndof)
        xf = np.random.default_rng(3).normal(size=W2.ndof)
        out = [_np(cp.Prolongate(1, cast(xc))), _np(cp.Restrict(1, cast(xf))),
               _np(cp.matvec(cast(xc))), _np(cp.T.matvec(cast(xf)))]
        mod = jmg if N is J else tmg
        P = mod.prolongation_matrix(N.H1(m1, order=1, **kw),
                                    N.H1(m2, order=1, **kw), **kw)
        n1 = W1.components[0].ndof
        assert _rel(out[0][:P.shape[0]], _np(P.matvec(cast(xc[:n1])))) <= 1e-14
        assert _rel(out[0][P.shape[0]:], _np(P.matvec(cast(xc[n1:])))) <= 1e-14
        res[N] = out
        if N is T:
            lst = T.CompoundProlongation([P, P])
            assert _rel(_np(lst.matvec(cast(xc))), out[0]) <= 1e-14
            assert _rel(_np(lst.T.matvec(cast(xf))), out[1]) <= 1e-14
    for a, b in zip(res[T], res[J]):
        assert _rel(a, b) <= 1e-14


def test_projectshift_free_function_matches_class():
    """tests/test_cutmg_api.py::test_projectshift_free_function_matches_class
    on the port."""
    mesh = _sq_mesh(T, 8)
    levelset = T.sqrt(T.x * T.x + T.y * T.y) - 0.6
    la = T.LevelSetMeshAdaptation(mesh, order=2, threshold=0.5, **CPU)
    la.CalcDeformation(levelset)
    lset_ho = T.GridFunction(T.H1(mesh, order=2, **CPU))
    lset_ho.Set(levelset)
    lset_p1 = T.GridFunction(T.H1(mesh, order=1, **CPU))
    T.InterpolateToP1(lset_ho, lset_p1)
    deform = T.GridFunction(T.VectorH1(mesh, order=2, **CPU))
    T.ProjectShift(lset_ho, lset_p1, deform, threshold=0.5)
    assert np.allclose(_np(deform._arr), _np(la.deform._arr), atol=1e-12)
    d_free = T.CalcMaxDistance(levelset, lset_p1, deform)
    d_cls = la.CalcMaxDistance()
    assert abs(d_free - d_cls) < 1e-12 + 1e-8 * abs(d_cls)
    mx, l1, l2 = T.CalcDistances(levelset, lset_p1, deform)
    assert abs(mx - d_cls) < 1e-12 + 1e-8 * abs(d_cls)
    assert 0 < l1 <= mx and 0 < l2 <= mx
    assert T.CalcMaxDistance(lset_ho, lset_p1, deform) < 0.05


def test_cxx_class_name_aliases():
    assert T.CXFESpace is T.XFESpace
    assert T.CSpaceTimeFESpace is T.SpaceTimeFESpace


def test_chip_smoke_mg_mesh_phases_on_cpu(monkeypatch):
    """chip_smoke.py's phases 24-25 end to end on the CPU with the sizes cut
    small (CPU tensors launch no kernel and the default Inverse() is the
    host LU there): every check runs; MG-CG repeats bit for bit and counts
    its ELL products."""
    import chip_smoke as cs
    from ngsxfem_tpu_torch.examples import integrate_curved, lsetgeoms

    run_c, run_q, run_l = (integrate_curved.run_curved,
                           integrate_curved.run_quads, lsetgeoms.run)
    for mod, name, val in (
            (cs, "card", lambda: "CPU"),
            (cs, "CUTMG_BIG", ((2, 8, 2), (3, 2, 2))),
            (cs, "CUTMG_PARITY", ((2, 8, 2),)), (cs, "P2TG_NX", 8),
            (cs, "REFINE_CASES", (("trig", 4), ("tet", 2), ("quad", 4),
                                  ("hex", 2))),
            (cs, "LSREF_CASES", (("trig", 8, 2), ("tet", 4, 2))),
            (cs, "UNSTR_NPTS", 300), (cs, "UNSTR_PARITY_NPTS", 200),
            (cs, "COMPOSITE_NX", 16),
            (integrate_curved, "run_curved",
             lambda **kw: run_c(order=3, nref=2, nx0=4, **kw)),
            (integrate_curved, "run_quads", lambda **kw: run_q(nref=3, **kw)),
            (lsetgeoms, "run",
             lambda **kw: run_l(geoms=("sphere",), nref=2, **kw))):
        monkeypatch.setattr(mod, name, val)
    cpu = torch.device("cpu")
    r = cs.cutmg_card(T, cpu, 2, 8, 2)
    assert r["products"] > 10 * r["it_mg"] and r["launches"] == 0
    assert cs.phases_24_25(T, cpu, 0.0) == (0, 0, [])
