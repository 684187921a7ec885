"""Periodic spaces and material regions in the PyTorch port, against the
JAX package (CPU, f64).

- ``MakeStructured*DMesh(periodic=...)``: ``periodic_facet_np`` bitwise;
  ``Periodic(space)``: ``base2comp``, ``comp2base``, ``el2dof`` and the
  Dirichlet marks bitwise, and the DG rule (``Periodic(L2)`` keeps its
  dofs: 24, not 6; tests/test_regressions.py:608);
- the periodic solve of tests/test_misc.py:162-188 (-u'' + u = cos(2 pi x),
  periodic in x) to 1e-10 against the JAX package, its error falling more
  than 3.2x per halving of h;
- the periodic facet algebra (tests/test_misc.py:137-159) bitwise;
- ``LevelSetMeshAdaptation(periodic=True)`` (tests/test_fem_review.py:131)
  to 1e-12, and its space-time twin's construction;
- ``GetMaterials``, ``Materials(...).Mask()`` and region-wise integrals
  (tests/test_unstructured.py:219-288, tests/test_regressions.py:492-516),
  and ``definedon=Region`` in ``Integrate`` and in the forms;
- ``AssembleOperator`` on a periodic space takes the partial assembly: the
  seam couples dofs ~nx-1 lattice steps apart, past ``stencil_guard``;
- ``Refine`` refuses a periodic mesh (tests/test_regressions.py:61).
"""
import math

import numpy as np
import pytest
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu.fem.space import L2 as JL2

CPU = "cpu"


def _meshes(M, case):
    dim, et, n, per = case
    if dim == 2:
        return M.MakeStructured2DMesh(quads=et == "quad", nx=n, ny=n + 1,
                                      periodic=per)
    return M.MakeStructured3DMesh(hexes=et == "hex", nx=n, ny=n, nz=n,
                                  periodic=per)


CASES = [(2, "trig", 4, "x"), (2, "trig", 3, "xy"), (2, "quad", 4, "y"),
         (3, "tet", 2, "xyz"), (3, "hex", 2, "xz")]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}-{c[3]}")
def test_periodic_identification_bitwise(case):
    jm, tm = _meshes(J, case), _meshes(T, case)
    assert np.array_equal(jm.periodic_facet_np, tm.periodic_facet_np)
    assert tm.periodic_axes == case[3]
    assert (tm.periodic_facet_np >= 0).sum() > 0
    for order in (1, 2):
        jp = J.Periodic(J.H1(jm, order=order, dirichlet=[1]))
        tp = T.Periodic(T.H1(tm, order=order, dirichlet=[1], device=CPU))
        for attr in ("base2comp", "comp2base", "el2dof_np", "dirichlet_dofs",
                     "bc_of_dof", "dof_rep_elem", "dof_rep_local"):
            assert np.array_equal(np.asarray(getattr(jp, attr)),
                                  np.asarray(getattr(tp, attr))), attr
        assert tp.ndof == jp.ndof < tp.base.ndof


def test_periodic_keeps_dg_apart():
    mesh = T.MakeStructured2DMesh(quads=False, nx=2, ny=2, periodic="x")
    assert T.Periodic(T.H1(mesh, order=1, device=CPU)).ndof == 6
    L = T.L2(mesh, order=1, device=CPU)
    assert T.Periodic(L).ndof == L.ndof == 24
    V2 = T.H1(mesh, order=2, device=CPU)
    assert T.Periodic(V2).ndof == V2.ndof - 5
    with pytest.raises(ValueError, match="no periodic identification"):
        T.Periodic(T.H1(T.MakeStructured2DMesh(nx=2, ny=2), device=CPU))


def _periodic_solve(M, nx, **dev):
    mesh = M.MakeStructured2DMesh(quads=False, nx=nx, ny=nx, periodic="x")
    P = M.Periodic(M.H1(mesh, order=1, **dev))
    u, v = P.TnT()
    a = M.BilinearForm(P)
    a += M.SymbolicBFI(form=M.grad(u) * M.grad(v) + u * v)
    f = M.LinearForm(P)
    f += M.SymbolicLFI(form=M.cos(2 * np.pi * M.x) * v)
    a.Assemble()
    f.Assemble()
    gfu = M.GridFunction(P)
    gfu.vec.data = a.mat.Inverse() * f.vec.data
    exact = M.cos(2 * np.pi * M.x) / (1 + 4 * np.pi ** 2)
    err = M.Integrate(cf=(gfu - exact) ** 2, mesh=mesh, order=6, **dev)
    return np.asarray(gfu.vec.data), float(err) ** 0.5, a


def test_periodic_solve_matches_jax():
    errs = []
    for nx in (8, 16):
        uj, ej, _ = _periodic_solve(J, nx)
        ut, et, a = _periodic_solve(T, nx, device=CPU)
        assert ut.shape == ((nx + 1) ** 2 - (nx + 1),)
        assert np.abs(ut - uj).max() <= 1e-10 * np.abs(uj).max()
        assert abs(et - ej) <= 1e-10 * ej
        errs.append(et)
    assert errs[1] < errs[0] / 3.2, errs
    # the seam couples dofs nx - 1 lattice steps apart: past the stencil
    # guard, AssembleOperator takes the partial assembly
    op = a.AssembleOperator()
    assert op.kind == "pa" and a.operator_kind == "pa"
    with pytest.raises(ValueError, match="reach"):
        a.AssembleOperator(lattice=True)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(ut.shape))
    y = a.mat.matvec(x)
    assert float((op.matvec(x) - y).abs().max()) <= 1e-12 * float(
        y.abs().max())


def test_periodic_facet_algebra_bitwise():
    for per in ("x", ""):
        jm = J.MakeStructured2DMesh(quads=False, nx=4, ny=4, periodic=per)
        tm = T.MakeStructured2DMesh(quads=False, nx=4, ny=4, periodic=per)
        cents = tm.vertices_np[tm.elements_np].mean(1)
        a, b = cents[:, 0] < 1 / 4, cents[:, 0] > 3 / 4
        for kw in (dict(bnd_val_a=False, bnd_val_b=False),
                   dict(use_and=False), {}):
            fj = J.GetFacetsWithNeighborTypes(jm, a=a, b=b, **kw)
            ft = T.GetFacetsWithNeighborTypes(tm, a=a, b=b, **kw)
            assert np.array_equal(fj.a, ft.a), (per, kw)
            assert np.array_equal(
                J.GetElementsWithNeighborFacets(jm, fj).a,
                T.GetElementsWithNeighborFacets(tm, ft).a)
        if per:
            f = T.GetFacetsWithNeighborTypes(tm, a=a, b=b, bnd_val_a=False,
                                             bnd_val_b=False)
            assert f.NumSet() == 4
            assert T.GetElementsWithNeighborFacets(tm, f).NumSet() == 8


def test_lsetcurv_periodic_matches_jax():
    def run(M, **dev):
        mesh = M.MakeStructured2DMesh(quads=False, nx=8, ny=8, periodic="x")
        phi = M.y - 0.5 - 0.1 * M.sin(2 * math.pi * M.x)
        lsa = M.LevelSetMeshAdaptation(mesh, order=2, periodic=True, **dev)
        deform = lsa.CalcDeformation(phi)
        return (lsa, np.asarray(deform.vec.data),
                lsa.CalcMaxDistance(phi))

    lj, dj, mj = run(J)
    lt, dt, mt = run(T, device=CPU)
    assert lt.deform_space.ndof == lj.deform_space.ndof
    assert lt.deform_space.ndof < 2 * lt.ho_space.ndof  # seam unified
    assert np.abs(dt - dj).max() <= 1e-12
    assert abs(mt - mj) <= 1e-12 and mt < 5e-3
    st = T.LevelSetMeshAdaptation_Spacetime(
        T.MakeStructured2DMesh(quads=False, nx=4, ny=4, periodic="x"),
        order_space=2, order_time=1, periodic=True, device=CPU)
    assert isinstance(st.nodal.deform_space.scalar, T.PeriodicFESpace)


def _material_mesh(M):
    base = M.MakeStructured2DMesh(quads=False, nx=4, ny=4)
    cent = base.vertices_np[base.elements_np].mean(1)
    mat = np.where(cent[:, 0] < 0.5, 1, 2).astype(np.int32)
    return M.MeshFromArrays("trig", base.vertices_np, base.elements_np,
                            mat_of_el=mat,
                            mat_names={1: "left", 2: "right"}), mat


def test_materials_and_region_wise_integrals():
    tm, mat = _material_mesh(T)
    jm, _ = _material_mesh(J)
    assert tm.GetMaterials() == jm.GetMaterials() == ("left", "right")
    for pat in ("left", "left|right", "nomatch", "r.*"):
        assert np.array_equal(tm.Materials(pat).Mask(),
                              jm.Materials(pat).Mask()), pat
    assert tm.Materials("left").Mask().sum() == int((mat == 1).sum())
    assert tm.Materials("left|right").Mask().all()
    vols = T.Integrate(cf=1.0, mesh=tm, order=1, region_wise=True,
                       device=CPU)
    assert np.allclose(vols, [0.5, 0.5], atol=1e-12)
    lj, lt = J.GridFunction(J.H1(jm, order=1)), T.GridFunction(
        T.H1(tm, order=1, device=CPU))
    J.InterpolateToP1(J.x - 0.25, lj)
    T.InterpolateToP1(T.x - 0.25, lt)
    sj = J.Integrate({"levelset": lj, "domain_type": J.NEG}, cf=1.0, mesh=jm,
                     order=0, region_wise=True)
    st = T.Integrate({"levelset": lt, "domain_type": T.NEG}, cf=1.0, mesh=tm,
                     order=0, region_wise=True)
    assert np.abs(np.asarray(sj) - st).max() <= 1e-12
    assert np.allclose(st, [0.25, 0.0], atol=1e-12)
    with pytest.raises(ValueError):
        T.Integrate(cf=1.0, mesh=tm, order=1, region_wise=True,
                    element_wise=True, device=CPU)
    # definedon: the region's share of an integral, and of a form
    right = tm.Materials("right")
    assert abs(T.Integrate(cf=T.x, mesh=tm, order=2, definedon=right,
                           device=CPU) - 0.375) < 1e-12
    cut = T.Integrate({"levelset": lt, "domain_type": T.POS}, cf=1.0,
                      mesh=tm, order=1, definedon=tm.Materials("left"))
    assert abs(cut - 0.25) < 1e-12
    V = T.H1(tm, order=1, device=CPU)
    u, v = V.TnT()
    f = T.LinearForm(V)
    f += T.SymbolicLFI(form=v, definedon=right)
    f.Assemble()
    a = T.BilinearForm(V)
    a += T.SymbolicBFI(form=u * v, definedon=right)
    a.Assemble()
    one = torch.ones(V.ndof, dtype=torch.float64)
    assert abs(float(f.vec.data.sum()) - 0.5) < 1e-12
    assert abs(float(one @ a.mat.matvec(one)) - 0.5) < 1e-12
    with pytest.raises(NotImplementedError):
        T.SymbolicBFI(form=u * v, skeleton=True, definedon=right)


def test_region_wise_multi_material_matches_jax():
    """tests/test_regressions.py:489-516: sparse ids and a declared-but-
    empty material, in GetMaterials() order."""
    out = []
    for M, dev in ((J, {}), (T, {"device": CPU})):
        mesh = M.MakeStructured2DMesh(quads=False, nx=4, ny=4)
        cent = mesh.vertices_np[mesh.elements_np].mean(axis=1)
        mesh.mat_of_el_np = np.where(cent[:, 0] < 0.5, 1, 3).astype(np.int32)
        mesh.mat_names = {1: "left", 3: "right", 5: "ghost"}
        assert mesh.GetMaterials() == ("left", "right", "ghost")
        vols = np.asarray(M.Integrate(cf=1.0, mesh=mesh, order=1,
                                      region_wise=True, **dev))
        mom = np.asarray(M.Integrate(cf=M.x, mesh=mesh, order=2,
                                     region_wise=True, **dev))
        assert mesh.Materials("ghost").Mask().sum() == 0
        assert mesh.Materials("left|right").Mask().sum() == mesh.ne
        out.append((vols, mom))
    (vj, mj), (vt, mt) = out
    assert np.abs(vt - vj).max() <= 1e-12 and np.abs(mt - mj).max() <= 1e-12
    assert np.allclose(mt, [0.125, 0.375, 0.0], atol=1e-12)


def test_refine_refuses_periodic_mesh():
    mesh = T.MakeStructured2DMesh(quads=False, nx=4, ny=4, periodic="x")
    with pytest.raises(NotImplementedError, match="periodic"):
        mesh.Refine()
    m2 = T.MakeStructured2DMesh(quads=False, nx=4, ny=4)
    m2.Refine()
    assert len(m2.periodic_facet_np) == m2.nfacets
    assert (m2.periodic_facet_np == -1).all()


def test_periodic_l2_matches_jax():
    jm = J.MakeStructured2DMesh(quads=False, nx=2, ny=2, periodic="x")
    tm = T.MakeStructured2DMesh(quads=False, nx=2, ny=2, periodic="x")
    pj, pt = J.Periodic(JL2(jm, order=1)), T.Periodic(T.L2(tm, order=1,
                                                           device=CPU))
    assert np.array_equal(pj.el2dof_np, pt.el2dof_np)


def test_chip_smoke_phases_26_27_on_cpu(monkeypatch):
    """chip_smoke.py's phases 26-27 end to end on the CPU with the sizes cut
    small (CPU tensors launch no kernel and the default Inverse() is the
    host LU there): every check runs, the ELL products of the general
    compliance are one forward and one transposed per CG step."""
    import chip_smoke as cs
    from ngsxfem_tpu_torch.models import poisson

    for mod, name, val in ((cs, "card", lambda: "CPU"), (cs, "AD_NX", 6),
                           (cs, "SHAPE_NX", 64), (cs, "COMP_FD_NX", 24),
                           (cs, "COMP_BIG_NX", 16), (cs, "PER_NX", (16, 32))):
        monkeypatch.setattr(mod, name, val)
    cpu = torch.device("cpu")
    model = poisson.UnfittedPoisson(nx=6, dim=3, order=1,
                                    dtype=torch.float64, device=cpu)
    assert cs.phases_26_27(T, cpu, 0.0, model) == (0, 0, [])
