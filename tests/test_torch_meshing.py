"""Meshing, refinement and mesh I/O of the PyTorch port against the JAX
package.

``Mesh.Refine`` (uniform and marked, trig / tet / quad / hex),
``RefineAtLevelSet`` / ``MarkForRefinement``, ``MeshFromArrays``,
``MakeUnstructuredMesh(seed)``, ``WriteGmsh`` -> ``ReadGmsh`` and
``SplineGeometry.GenerateMesh`` give the JAX package's vertices, elements,
boundary ids and marks bit for bit (host numpy and scipy in both).  The
cases of ``tests/test_refine.py``, ``tests/test_splinegeom.py``,
``tests/test_composite.py`` and ``tests/test_unstructured.py`` (but the two
that need ``Mesh.Materials``, ROADMAP A9d) run on the port with their
tolerances, tensors on the CPU in float64; ``IntegrateC`` and the
quad-dominated fictitious-domain solve agree with the JAX package to 1e-12
and 1e-8, and the examples ``unstructured_nxfem``, ``integrate_curved`` and
``lsetgeoms`` to 1e-8 at small sizes.
"""
import math
import os
import sys
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CPU = {"device": "cpu"}
PKGS = ((J, {}), (T, CPU))


def _same_mesh(mt, mj, refined=False):
    """Equal meshes.  After ``Refine`` the JAX package keeps the coarse
    mesh's ``mat_of_el_np``; the port's children inherit their parent's id
    (here every id is 1)."""
    assert mt.et == mj.et and (mt.nv, mt.ne) == (mj.nv, mj.ne)
    for attr in ("vertices_np", "elements_np", "bc_of_facet_np", "facets_np",
                 "facet2el_np") + (() if refined else ("mat_of_el_np",)):
        a, b = getattr(mt, attr), getattr(mj, attr)
        assert a.dtype == b.dtype and np.array_equal(a, b), attr
    if refined:
        assert np.array_equal(mt.mat_of_el_np, np.ones(mt.ne, np.int32))
    assert mt.bc_names == mj.bc_names


def _struct(N, et, n):
    if et in ("trig", "quad"):
        return N.MakeStructured2DMesh(quads=et == "quad", nx=n, ny=n)
    return N.MakeStructured3DMesh(hexes=et == "hex", nx=n, ny=n, nz=n)


def _p1(N, mesh, cf, kw):
    gf = N.GridFunction(N.H1(mesh, order=1, **kw))
    N.InterpolateToP1(cf, gf)
    return gf


def _area(mesh):
    v = mesh.vertices_np[mesh.elements_np]
    E = v[:, 1:] - v[:, :1]
    vol = np.abs(np.linalg.det(E)) / math.factorial(mesh.dim)
    assert (vol > 1e-16).all()
    return vol.sum()


# -- refinement ------------------------------------------------------------

@pytest.mark.parametrize("et,n", [("trig", 3), ("tet", 2), ("quad", 2),
                                  ("hex", 2)])
def test_uniform_refine_matches_reference(et, n):
    """Uniform ``Refine()`` twice: the JAX package's mesh bit for bit; the
    measure stays 1 (tests/test_refine.py), spaces see the new mesh and
    the mesh's views and version are renewed."""
    mj, mt = _struct(J, et, n), _struct(T, et, n)
    V = T.H1(mt, order=1, **CPU)
    mt.device_view("cpu", torch.float64)
    ne0, v0 = mt.ne, mt._version
    for _ in range(2):
        mj.Refine()
        mt.Refine()
        _same_mesh(mt, mj, refined=True)
    assert mt._views == {} and mt._version == v0 + 2
    assert mt.ne == (16 * ne0 if et in ("trig", "quad")
                     else 64 * ne0 if et == "hex" else mt.ne)
    assert mt.ne > 4 * ne0
    val = T.Integrate(cf=T.CoefficientFunction(1.0), mesh=mt, order=2,
                      **CPU)
    assert abs(val - 1.0) < 1e-13
    assert T.H1(mt, order=1, **CPU).ndof == mt.nv != V.ndof


def test_quad_hex_uniform_refine_counts():
    """tests/test_refine.py's quad and hex cases: counts, bc ids kept, the
    quad circle EOC over in-place refinement, a cut on refined hexes."""
    mesh = T.MakeStructured2DMesh(quads=True, nx=2, ny=2)
    bf = lambda m: sorted(set(int(b) for b in m.bc_of_facet_np[
        m.boundary_facets_np]))
    nbc0 = bf(mesh)
    mesh.Refine()
    assert (mesh.ne, mesh.nv, len(mesh.boundary_facets_np)) == (16, 25, 16)
    assert bf(mesh) == nbc0
    r, errors = 0.6, []
    for _ in range(3):
        lsp1 = _p1(T, mesh, T.sqrt(T.x * T.x + T.y * T.y) - r, CPU)
        a = T.Integrate({"levelset": lsp1, "domain_type": T.NEG},
                        cf=T.CoefficientFunction(1.0), mesh=mesh, order=2)
        errors.append(abs(a - math.pi * r * r / 4))
        mesh.Refine()
    eoc = [math.log(errors[i] / errors[i + 1]) / math.log(2) for i in range(2)]
    assert sum(eoc) / len(eoc) > 1.75, (errors, eoc)
    hexm = T.MakeStructured3DMesh(hexes=True, nx=2, ny=2, nz=2)
    hexm.Refine()
    assert (hexm.ne, hexm.nv, len(hexm.boundary_facets_np)) == (64, 125, 96)
    lsp1 = _p1(T, hexm, 1 - 2 * T.x - 2 * T.y - 2 * T.z, CPU)
    a = T.Integrate({"levelset": lsp1, "domain_type": T.NEG},
                    cf=T.CoefficientFunction(1.0), mesh=hexm, order=2)
    assert abs(a - 47.0 / 48) < 1e-12
    marks = np.zeros(mesh.ne, dtype=bool)
    marks[0] = True
    with pytest.raises(NotImplementedError):
        mesh.Refine(marks)


@pytest.mark.parametrize("et,n", [("trig", 8), ("tet", 4)])
def test_refine_at_levelset_loop_matches_reference(et, n):
    """The adaptive loop of tests/test_refine.py (RefineAtLevelSet + Refine,
    three levels) in both packages: equal marks and meshes each level; the
    geometry error falls as that test asks, at far below uniform cost."""
    meshes = {N: _struct(N, et, n) for N, _ in PKGS}
    c = 0.5
    errs, nes = [], []
    for _ in range(3):
        marks = {}
        for N, kw in PKGS:
            r2 = (N.x - c) ** 2 + (N.y - c) ** 2
            if et == "tet":
                r2 = r2 + (N.z - c) ** 2
            lset = _p1(N, meshes[N], N.sqrt(r2) - 0.3, kw)
            if N is T:
                vol = T.Integrate({"levelset": lset, "domain_type": T.NEG},
                                  cf=T.CoefficientFunction(1.0),
                                  mesh=meshes[T], order=2)
                exact = (math.pi * 0.09 if et == "trig"
                         else 4.0 / 3.0 * math.pi * 0.3 ** 3)
                errs.append(abs(vol - exact))
                nes.append(meshes[T].ne)
                assert abs(_area(meshes[T]) - 1.0) < 1e-13
            marks[N] = np.asarray(N.RefineAtLevelSet(lset).a)
            meshes[N].Refine()
        assert 0 < marks[T].sum() < len(marks[T])
        assert np.array_equal(marks[T], marks[J])
        _same_mesh(meshes[T], meshes[J], refined=True)
    if et == "trig":
        assert errs[2] < errs[0] / 8 and nes[2] < 16 * nes[0] / 2
    else:
        assert errs[2] < errs[0] / 2.5 and nes[2] < 64 * nes[0] / 2


def test_refine_at_levelset_area():
    """tests/test_refine.py::test_refine_at_levelset on the port."""
    mesh = T.MakeStructured2DMesh(quads=False, nx=8, ny=8)
    cf = lambda: T.sqrt((T.x - 0.5) ** 2 + (T.y - 0.5) ** 2) - 0.3
    for _ in range(2):
        marks = T.RefineAtLevelSet(_p1(T, mesh, cf(), CPU))
        assert 0 < marks.NumSet() < mesh.ne
        mesh.Refine()
        assert abs(_area(mesh) - 1.0) < 1e-13
    area = T.Integrate({"levelset": _p1(T, mesh, cf(), CPU),
                        "domain_type": T.NEG},
                       cf=T.CoefficientFunction(1.0), mesh=mesh, order=2)
    assert abs(area - math.pi * 0.09) < 2e-3


def test_mark_for_refinement_matches_reference():
    """tests/test_refine.py::test_mark_for_refinement in both packages:
    equal marks, the refined meshes equal, area 4."""
    out = {}
    for N, kw in PKGS:
        mesh = N.MakeStructured2DMesh(
            quads=False, nx=8, ny=8,
            mapping=lambda a, b: (2 * a - 1, 2 * b - 1))
        lsa = N.LevelSetMeshAdaptation(mesh, order=2, threshold=1000, **kw)
        phi = N.sqrt(N.x * N.x + N.y * N.y) - 0.6
        lsa.CalcDeformation(phi)
        marks = np.asarray(lsa.MarkForRefinement(phi, refine_threshold=0.5).a)
        mesh.Refine()
        out[N] = (marks, mesh)
    assert 0 < out[T][0].sum() < len(out[T][0])
    assert np.array_equal(out[T][0], out[J][0])
    _same_mesh(out[T][1], out[J][1], refined=True)
    assert abs(_area(out[T][1]) - 4.0) < 1e-12


def test_tet_bisection_conformity():
    """tests/test_refine.py::test_tet_bisection_conformity on the port's
    ``bisect_refine_tet``, equal to the JAX package's output (three values,
    as there); the children's parents from ``_bisect_tet``."""
    from ngsxfem_tpu.mesh.refine import bisect_refine_tet as jax_bisect
    from ngsxfem_tpu_torch.mesh.refine import _bisect_tet, bisect_refine_tet

    def violations(V, E):
        bad = 0
        P = V[np.unique(E)]
        for t in E:
            for i in range(4):
                for j in range(i + 1, 4):
                    a, b = V[t[i]], V[t[j]]
                    d = b - a
                    L2 = d @ d
                    if L2 < 1e-24:
                        bad += 1000
                        continue
                    s = ((P - a) @ d) / L2
                    on = (s > 1e-9) & (s < 1 - 1e-9)
                    if not on.any():
                        continue
                    proj = a + s[:, None] * d
                    bad += int((on & (((P - proj) ** 2).sum(1) < 1e-18)).sum())
        return bad

    def vol(V, E):
        a, b, c, d = V[E[:, 0]], V[E[:, 1]], V[E[:, 2]], V[E[:, 3]]
        return np.abs(np.einsum("ij,ij->i", np.cross(b - a, c - a),
                                d - a)).sum() / 6

    rng = np.random.default_rng(0)
    mesh = T.MakeStructured3DMesh(hexes=False, nx=3, ny=3, nz=3)
    V, E = mesh.vertices_np.astype(np.float64), mesh.elements_np
    for _ in range(4):
        marks = rng.random(len(E)) < 0.1
        Vn, En, _ = bisect_refine_tet(V, E, marks)
        parent = _bisect_tet(V, E, marks)[3]
        Vj, Ej, _ = jax_bisect(V, E, marks)
        assert np.array_equal(Vn, Vj) and np.array_equal(En, Ej)
        assert violations(Vn, En) == 0
        assert abs(vol(Vn, En) - vol(V, E)) < 1e-12
        # the children of each coarse tet fill it
        kid = np.zeros(len(E))
        np.add.at(kid, parent, [vol(Vn, En[i:i + 1]) for i in range(len(En))])
        par = np.array([vol(V, E[i:i + 1]) for i in range(len(E))])
        assert np.abs(kid - par).max() < 1e-14


def test_refine_keeps_materials():
    """Children keep their parent's material id, on trigs and tets
    (marked) and quads; the JAX package leaves ``mat_of_el_np`` of the coarse mesh."""
    base = T.MakeStructured2DMesh(quads=False, nx=4, ny=4)
    cent = base.vertices_np[base.elements_np].mean(1)
    mat = np.where(cent[:, 0] < 0.5, 1, 2).astype(np.int32)
    m = T.MeshFromArrays("trig", base.vertices_np, base.elements_np,
                         mat_of_el=mat)
    marks = cent[:, 1] < 0.3
    m.Refine(marks)
    c2 = m.vertices_np[m.elements_np].mean(1)
    assert np.array_equal(m.mat_of_el_np, np.where(c2[:, 0] < 0.5, 1, 2))
    vols = T.Integrate(cf=1.0, mesh=m, order=1, region_wise=True, **CPU)
    assert np.allclose(vols, [0.5, 0.5], atol=1e-12)
    q = T.MakeStructured2DMesh(quads=True, nx=2, ny=2)
    q = T.MeshFromArrays("quad", q.vertices_np, q.elements_np,
                         mat_of_el=[1, 2, 1, 2])
    q.Refine()
    assert np.array_equal(q.mat_of_el_np, np.repeat([1, 2, 1, 2], 4))
    base = T.MakeStructured3DMesh(hexes=False, nx=2, ny=2, nz=2)
    cent = base.vertices_np[base.elements_np].mean(1)
    t = T.MeshFromArrays("tet", base.vertices_np, base.elements_np,
                         mat_of_el=np.where(cent[:, 2] < 0.5, 1, 2))
    t.Refine(cent[:, 0] < 0.5)
    c2 = t.vertices_np[t.elements_np].mean(1)
    assert np.array_equal(t.mat_of_el_np, np.where(c2[:, 2] < 0.5, 1, 2))


# -- mesh I/O and Delaunay ---------------------------------------------------

def _perturbed(N, dim, nx, amp=0.25, seed=3):
    """tests/test_unstructured.py's structured simplicial mesh with randomly
    shifted interior vertices, through ``MeshFromArrays``."""
    m = _struct(N, "trig" if dim == 2 else "tet", nx)
    V = m.vertices_np.copy()
    rng = np.random.default_rng(seed)
    h = 1.0 / nx
    interior = np.all((V > 1e-12) & (V < 1 - 1e-12), axis=1)
    V[interior] += rng.uniform(-amp * h, amp * h, size=V[interior].shape)
    mm = N.MeshFromArrays(m.et, V, m.elements_np)
    mm.bc_of_facet_np = m.bc_of_facet_np
    return mm


@pytest.mark.parametrize("dim", [2, 3])
def test_perturbed_linear_lset_exact(dim):
    """MeshFromArrays equal to the JAX package's; a linear level set on a
    distorted mesh is exact (tests/test_unstructured.py)."""
    mesh = _perturbed(T, dim, 8)
    _same_mesh(mesh, _perturbed(J, dim, 8))
    lset = _p1(T, mesh, T.x - 0.5, CPU)
    ld = lambda dt: {"levelset": lset, "domain_type": dt}
    assert abs(T.Integrate(ld(T.NEG), cf=1.0, mesh=mesh, order=2) - 0.5) < 1e-11
    assert abs(T.Integrate(ld(T.IF), cf=1.0, mesh=mesh, order=2) - 1.0) < 1e-9


def test_perturbed_circle_eoc():
    errs = []
    for nx in (8, 16, 32, 64):
        mesh = _perturbed(T, 2, nx)
        lset = _p1(T, mesh, T.sqrt((T.x - 0.5) ** 2 + (T.y - 0.5) ** 2) - 0.3,
                   CPU)
        a = T.Integrate({"levelset": lset, "domain_type": T.NEG}, cf=1.0,
                        mesh=mesh, order=2)
        errs.append(abs(a - np.pi * 0.09))
    eocs = [np.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)]
    assert np.mean(eocs) > 1.6, (errs, eocs)


@pytest.mark.parametrize("dim,npts,seed", [(2, 400, 1), (3, 300, 2)])
def test_delaunay_unstructured(dim, npts, seed):
    """``MakeUnstructuredMesh(seed)`` equal to the JAX package's; it tiles
    the unit box and cuts exactly (tests/test_unstructured.py)."""
    mesh = T.MakeUnstructuredMesh(dim=dim, npts=npts, seed=seed)
    _same_mesh(mesh, J.MakeUnstructuredMesh(dim=dim, npts=npts, seed=seed))
    assert abs(T.Integrate(cf=1.0, mesh=mesh, order=1, **CPU) - 1.0) < 1e-12
    lin = T.x - 0.5 if dim == 2 else T.x + T.y - 1.0
    a = T.Integrate({"levelset": _p1(T, mesh, lin, CPU),
                     "domain_type": T.NEG}, cf=1.0, mesh=mesh, order=2)
    assert abs(a - 0.5) < 1e-12
    if dim == 2:
        lsc = _p1(T, mesh, T.sqrt((T.x - 0.5) ** 2 + (T.y - 0.5) ** 2) - 0.3,
                  CPU)
        ac = T.Integrate({"levelset": lsc, "domain_type": T.NEG}, cf=1.0,
                         mesh=mesh, order=2)
        assert abs(ac - np.pi * 0.09) < 4e-3


def test_nxfem_solve_perturbed_3d():
    """tests/test_unstructured.py::test_nxfem_solve_perturbed_3d on the
    port: the fictdom pipeline on a perturbed tet mesh, positive mean."""
    mesh = _perturbed(T, 3, 6)
    lsetp1 = _p1(T, mesh, T.sqrt((T.x - 0.5) ** 2 + (T.y - 0.5) ** 2
                                 + (T.z - 0.5) ** 2) - 0.3, CPU)
    ci = T.CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(T.HASNEG)
    hasif = ci.GetElementsOfType(T.IF)
    V = T.H1(mesh, order=1, dgjumps=True, **CPU)
    u, v = V.TnT()
    h = T.specialcf.mesh_size
    nl = 1.0 / T.Norm(T.grad(lsetp1)) * T.grad(lsetp1)
    gp = T.GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif)
    ld_neg = {"levelset": lsetp1, "domain_type": T.NEG}
    ld_if = {"levelset": lsetp1, "domain_type": T.IF}
    a = T.BilinearForm(V)
    a += T.SymbolicBFI(ld_neg, form=T.grad(u) * T.grad(v),
                       definedonelements=hasneg)
    a += T.SymbolicBFI(ld_if, form=-(T.grad(u) * nl) * v
                       - (T.grad(v) * nl) * u + 20.0 / h * u * v)
    a += T.SymbolicFacetPatchBFI(form=0.1 / (h * h) * (u - u.Other())
                                 * (v - v.Other()), definedonelements=gp)
    a.Assemble()
    f = T.LinearForm(V)
    f += T.SymbolicLFI(ld_neg, form=v, definedonelements=hasneg)
    f.Assemble()
    gfu = T.GridFunction(V)
    gfu.vec.data = a.mat.Inverse(freedofs=T.GetDofsOfElements(V, hasneg)) \
        * f.vec.data
    assert torch.isfinite(gfu.vec.data).all()
    assert T.Integrate(ld_neg, cf=gfu, mesh=mesh, order=3) > 0


def test_gmsh_roundtrip_matches_reference(tmp_path):
    """WriteGmsh -> ReadGmsh: the file equals the JAX package's byte for
    byte, the mesh read back equals its read-back; boundary ids and
    materials survive (tests/test_unstructured.py::test_gmsh_roundtrip)."""
    mt = T.MakeUnstructuredMesh(dim=2, npts=60, seed=7)
    mj = J.MakeUnstructuredMesh(dim=2, npts=60, seed=7)
    pt, pj = str(tmp_path / "t.msh"), str(tmp_path / "j.msh")
    T.WriteGmsh(mt, pt)
    J.WriteGmsh(mj, pj)
    assert open(pt).read() == open(pj).read()
    m2, j2 = T.ReadGmsh(pt), J.ReadGmsh(pj)
    _same_mesh(m2, j2)
    assert (m2.ne, m2.nv, m2.et) == (mt.ne, mt.nv, "trig")
    b1 = np.sort(mt.bc_of_facet_np[mt.boundary_facets_np])
    b2 = np.sort(m2.bc_of_facet_np[m2.boundary_facets_np])
    assert (b1 == b2).all()
    assert abs(T.Integrate(cf=1.0, mesh=m2, order=1, **CPU) - 1.0) < 1e-12
    base = T.MakeStructured3DMesh(hexes=False, nx=2, ny=2, nz=2)
    mat = np.where(base.vertices_np[base.elements_np].mean(1)[:, 2] < 0.5,
                   1, 2)
    m3 = T.MeshFromArrays("tet", base.vertices_np, base.elements_np,
                          bc_of_facet=base.bc_of_facet_np, mat_of_el=mat,
                          mat_names={1: "low", 2: "high"})
    p3 = str(tmp_path / "m3.msh")
    T.WriteGmsh(m3, p3)
    r3 = T.ReadGmsh(p3)
    assert np.array_equal(r3.mat_of_el_np, mat)
    assert np.allclose(T.Integrate(cf=1.0, mesh=r3, order=1,
                                   region_wise=True, **CPU), [0.5, 0.5])


def test_gmsh_mixed_cell_types_composite(tmp_path):
    """A .msh mixing trig and quad cells gives a CompositeMesh with both
    groups and a warning (tests/test_unstructured.py)."""
    msh = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
6
1 0 0 0
2 0.5 0 0
3 1 0 0
4 0 1 0
5 0.5 1 0
6 1 1 0
$EndNodes
$Elements
3
1 2 1 1 1 2 5
2 2 1 1 1 5 4
3 3 1 1 2 3 6 5
$EndElements
"""
    p = tmp_path / "mixed.msh"
    p.write_text(msh)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        m = T.ReadGmsh(str(p))
    assert isinstance(m, T.CompositeMesh)
    assert any("mixed cell types" in str(w.message) for w in rec)
    assert sorted(sm.et for sm in m.submeshes) == ["quad", "trig"]
    assert m.ne == 3 and m.nv == 6
    assert abs(T.IntegrateC(None, 1.0, m, order=1, **CPU) - 1.0) < 1e-14


def test_gmsh_errors(tmp_path):
    p = tmp_path / "v4.msh"
    p.write_text("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n")
    with pytest.raises(NotImplementedError, match="v2"):
        T.ReadGmsh(str(p))
    p.write_text("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
    with pytest.raises(ValueError, match="no nodes"):
        T.ReadGmsh(str(p))
    with pytest.raises(ValueError, match="vertices"):
        T.MeshFromArrays("tet", np.zeros((3, 3)), [[0, 1, 2]])


def test_nxfem_solve_unstructured_matches_reference():
    """``examples.unstructured_nxfem``: the spline mesher and the Delaunay
    mesher (with and without the Gmsh round trip), L2 errors equal to the
    JAX example's to 1e-8 (npts 300); the reference threshold 0.06 at the
    Delaunay npts=900 (tests/test_unstructured.py)."""
    from ngsxfem_tpu_torch.examples import unstructured_nxfem as tu
    from examples import unstructured_nxfem as ju

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for kw in (dict(mesher="spline"), dict(mesher="delaunay", npts=300),
                   dict(mesher="delaunay", npts=300, via_gmsh=True)):
            ej = ju.run(verbose=False, **kw)
            et = tu.run(verbose=False, **kw, **CPU)
            assert abs(et - ej) <= 1e-8 * ej, (kw, et, ej)
        err = tu.run(mesher="delaunay", npts=900, seed=5, verbose=False, **CPU)
    assert err < 0.06, err


# -- spline geometry ---------------------------------------------------------

def _mesh_rect(N, maxh=0.2):
    sq = N.SplineGeometry()
    sq.AddRectangle([-1.5, -1.5], [1.5, 1.5], bc=1)
    return N.Mesh(sq.GenerateMesh(maxh=maxh, quad_dominated=False))


def test_rectangle_mesh_area_and_quality():
    mesh = _mesh_rect(T)
    _same_mesh(mesh, _mesh_rect(J))
    assert mesh.et == "trig" and mesh.ne > 100
    assert abs(float(T.Integrate(None, cf=1.0, mesh=mesh, order=2, **CPU))
               - 9.0) < 1e-12
    v = mesh.vertices_np[mesh.elements_np]
    mins = []
    for i in range(3):
        a, b, c = v[:, i], v[:, (i + 1) % 3], v[:, (i + 2) % 3]
        u1, u2 = b - a, c - a
        cosv = ((u1 * u2).sum(1) / np.linalg.norm(u1, axis=1)
                / np.linalg.norm(u2, axis=1))
        mins.append(np.degrees(np.arccos(np.clip(cosv, -1, 1))))
    assert np.stack(mins).min() > 20.0
    bf = mesh.boundary_facets_np
    assert len(bf) > 0 and (mesh.bc_of_facet_np[bf] == 1).all()
    p = mesh.vertices_np[np.unique(mesh.facets_np[bf])]
    assert (np.isclose(np.abs(p[:, 0]), 1.5)
            | np.isclose(np.abs(p[:, 1]), 1.5)).all()


def test_mesh_passthrough_and_quad_dominated_raises():
    sq = T.SplineGeometry()
    sq.AddRectangle([0, 0], [1, 1], bc=1)
    raw = sq.GenerateMesh(maxh=0.5)
    assert T.Mesh(raw) is raw
    with pytest.raises(NotImplementedError):
        sq.GenerateMesh(maxh=0.5, quad_dominated=True)


def test_circle_exact_boundary_and_bc_names():
    meshes = {}
    for N, _ in PKGS:
        geo = N.SplineGeometry()
        N.MakeCircle(geo, (0.0, 0.0), 1.0, bc="outer")
        meshes[N] = geo.GenerateMesh(maxh=0.15)
    mesh = meshes[T]
    _same_mesh(mesh, meshes[J])
    bverts = np.unique(mesh.facets_np[mesh.boundary_facets_np])
    r = np.linalg.norm(mesh.vertices_np[bverts], axis=1)
    assert np.abs(r - 1.0).max() < 1e-12
    assert mesh.bc_names == {1: "outer"}
    area = float(T.Integrate(None, cf=1.0, mesh=mesh, order=2, **CPU))
    assert 0 < np.pi - area < 0.02


def test_two_domain_materials_conforming_interface():
    """Two domains: the material ids and names equal to the JAX package's
    (``GetMaterials`` waits for ROADMAP A9d), region_wise sums, the
    conforming interface on the circle."""
    meshes = {}
    for N, _ in PKGS:
        g = N.SplineGeometry()
        g.AddRectangle([-1, -1], [1, 1], bc="wall", leftdomain=1)
        g.AddCircle((0.0, 0.0), 0.5, bc="interface", leftdomain=2,
                    rightdomain=1)
        g.SetMaterial(1, "outer")
        N.MakeRectangle(g, (2.0, 2.0), (2.5, 2.5), leftdomain=3)
        g.SetMaterial(2, "inner")
        meshes[N] = g.GenerateMesh(maxh=0.1)
    m = meshes[T]
    _same_mesh(m, meshes[J])
    assert m.mat_names == meshes[J].mat_names == {1: "outer", 2: "inner"}
    a = np.asarray(T.Integrate(None, cf=1.0, mesh=m, order=2,
                               region_wise=True, **CPU))
    assert abs(a[:2].sum() - 4.0) < 1e-12 and abs(a[2] - 0.25) < 1e-12
    assert abs(a[1] - np.pi * 0.25) < 0.01
    f2e, mats = m.facet2el_np, m.mat_of_el_np
    interf = (f2e[:, 1] >= 0) & (mats[f2e[:, 0]]
                                 != mats[np.maximum(f2e[:, 1], 0)])
    assert interf.sum() > 10
    r = np.linalg.norm(m.vertices_np[np.unique(m.facets_np[interf])], axis=1)
    assert np.abs(r - 0.5).max() < 1e-12


def test_unfitted_integrate_on_generated_mesh():
    mesh = _mesh_rect(T, maxh=0.2)
    ls = _p1(T, mesh, T.sqrt(T.x * T.x + T.y * T.y) - 1.0, CPU)
    a_neg = float(T.Integrate({"levelset": ls, "domain_type": T.NEG},
                              cf=1.0, mesh=mesh, order=3))
    a_pos = float(T.Integrate({"levelset": ls, "domain_type": T.POS},
                              cf=1.0, mesh=mesh, order=3))
    assert abs(a_neg - np.pi) < 0.05
    assert abs(a_neg + a_pos - 9.0) < 1e-10


# -- quad-dominated composite meshes -----------------------------------------

def test_quad_dominated_mesh_and_integratec_match_reference():
    """MakeQuadDominated2DMesh equal to the JAX package's; IntegrateC (plain,
    NEG, IF, a circle) equal to its to 1e-12; the exactness cases of
    tests/test_composite.py."""
    cm = T.MakeQuadDominated2DMesh(nx=10, ny=10, trig_band=0.4)
    assert {m.et for m in cm.submeshes} == {"quad", "trig"}
    assert cm.ne == 6 * 10 + 2 * 4 * 10
    assert abs(T.IntegrateC(None, 1.0, cm, order=2, **CPU) - 1.0) < 1e-13
    ct = T.MakeQuadDominated2DMesh(nx=8, ny=8, trig_band=0.5)
    cj = J.MakeQuadDominated2DMesh(nx=8, ny=8, trig_band=0.5)
    for a, b in zip(ct.submeshes, cj.submeshes):
        _same_mesh(a, b)
    for lsf in (lambda N: N.x + N.y - 0.8, lambda N: N.x - 0.75,
                lambda N: N.sqrt((N.x - 0.5) ** 2 + (N.y - 0.5) ** 2) - 0.3):
        lt = T.CompositeGridFunction(ct, **CPU).Set(lsf(T))
        lj = J.CompositeGridFunction(cj).Set(lsf(J))
        assert np.abs(lt.vec.numpy() - np.asarray(lj.vec)).max() <= 1e-14
        for dt in ("NEG", "IF"):
            vt = T.IntegrateC({"levelset": lt, "domain_type": getattr(T, dt)},
                              1.0, ct, order=3)
            vj = J.IntegrateC({"levelset": lj, "domain_type": getattr(J, dt)},
                              1.0, cj, order=3)
            assert abs(vt - vj) <= 1e-12 * abs(vj)
    lset = T.CompositeGridFunction(ct, **CPU).Set(T.x + T.y - 0.8)
    a = T.IntegrateC({"levelset": lset, "domain_type": T.NEG}, 1.0, ct, order=2)
    iflen = T.IntegrateC({"levelset": lset, "domain_type": T.IF}, 1.0, ct,
                         order=2)
    assert abs(a - 0.32) < 1e-13 and abs(iflen - 0.8 * np.sqrt(2)) < 1e-13


def test_quad_dominated_circle_eoc():
    errs = []
    for nx in (8, 16, 32):
        cm = T.MakeQuadDominated2DMesh(nx=nx, ny=nx, trig_band=0.5)
        lset = T.CompositeGridFunction(cm, **CPU).Set(
            T.sqrt((T.x - 0.5) ** 2 + (T.y - 0.5) ** 2) - 0.3)
        a = T.IntegrateC({"levelset": lset, "domain_type": T.NEG}, 1.0, cm,
                         order=3)
        errs.append(abs(a - np.pi * 0.09))
    eocs = [np.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)]
    assert np.mean(eocs) > 1.6, (errs, eocs)


def _quad_fictdom(N, kw):
    """tests/test_composite.py::test_quad_dominated_fictdom_solve."""
    cm = N.MakeQuadDominated2DMesh(nx=12, ny=12, trig_band=0.5)
    lset = N.CompositeGridFunction(cm, **kw).Set(
        N.sqrt((N.x - 0.5) ** 2 + (N.y - 0.5) ** 2) - 0.35)
    ci = N.CompositeCutInfo(cm, lset)
    hasneg_pg = ci.per_group(N.HASNEG)
    space = N.CompositeGridFunction(cm, **kw)

    def make_a(V, k):
        u, v = V.TnT()
        h = N.specialcf.mesh_size
        nl = 1.0 / N.Norm(N.grad(lset.gfs[k])) * N.grad(lset.gfs[k])
        a = N.BilinearForm(V)
        a += N.SymbolicBFI({"levelset": lset.gfs[k], "domain_type": N.NEG},
                           form=N.grad(u) * N.grad(v),
                           definedonelements=hasneg_pg[k])
        a += N.SymbolicBFI({"levelset": lset.gfs[k], "domain_type": N.IF},
                           form=-(N.grad(u) * nl) * v - (N.grad(v) * nl) * u
                           + 40.0 / h * u * v)
        return a

    def make_f(V, k):
        _, v = V.TnT()
        f = N.LinearForm(V)
        f += N.SymbolicLFI({"levelset": lset.gfs[k], "domain_type": N.NEG},
                           form=v, definedonelements=hasneg_pg[k])
        return f

    A = N.CompositeBilinearForm(space, make_a).Assemble()
    F = N.CompositeLinearForm(space, make_f).Assemble()
    act = np.zeros(cm.nv, dtype=bool)
    for k, m in enumerate(cm.submeshes):
        act[m.elements_np[np.asarray(hasneg_pg[k].np)].ravel()] = True
    u = A.mat.Inverse(freedofs=N.BitArray(act)) * F._vec
    return cm, act, np.asarray(u.cpu() if torch.is_tensor(u) else u), F, \
        np.asarray(ci.GetElementsOfType(N.HASNEG).np)


def test_quad_dominated_fictdom_solve_matches_reference():
    """The fictitious-domain solve assembled across the mixed groups: the
    solution equal to the JAX package's to 1e-8, the load vector to 1e-12,
    the reference test's sanity limits; the load sum is fixed-order."""
    cm, act, u, F, hn = _quad_fictdom(T, CPU)
    _, _, uj, Fj, hnj = _quad_fictdom(J, {})
    assert np.array_equal(hn, hnj)
    assert np.abs(F._vec.numpy() - np.asarray(Fj._vec)).max() <= 1e-12
    assert torch.equal(F.vec.data, F.Assemble()._vec)
    assert np.abs(u - uj).max() <= 1e-8 * np.abs(uj).max()
    assert np.all(np.isfinite(u))
    vid_center = np.argmin(np.linalg.norm(cm.vertices_np - 0.5, axis=1))
    assert abs(u[vid_center] - 0.35 ** 2 / 4) < 5e-3, u[vid_center]
    r = np.linalg.norm(cm.vertices_np - 0.5, axis=1)
    ring = act & (np.abs(r - 0.35) < 0.05)
    assert np.abs(u[ring]).max() < 2e-2


# -- examples ----------------------------------------------------------------

def test_integrate_curved_matches_reference():
    """``examples.integrate_curved`` at small sizes: the curved/uncurved
    errors and the quad-mesh EOC errors equal to the JAX example's to
    1e-8 (absolute on errors below 1)."""
    from ngsxfem_tpu_torch.examples import integrate_curved as ti
    from examples import integrate_curved as ji

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ut, ct = ti.run_curved(order=3, nref=2, nx0=4, verbose=False, **CPU)
        uj, cj = ji.run_curved(order=3, nref=2, nx0=4, verbose=False)
        qt = ti.run_quads(nref=4, verbose=False, **CPU)
        qj = ji.run_quads(nref=4, verbose=False)
    for a, b in ((ut, uj), (ct, cj), (qt, qj)):
        for k in a:
            assert np.abs(np.subtract(a[k], b[k])).max() <= 1e-8
    assert all(c < u for c, u in zip(ct[T.IF], ut[T.IF]))


def test_lsetgeoms_matches_reference():
    """``examples.lsetgeoms`` (sphere and torus, two levels): distances and
    EOCs equal to the JAX example's to 1e-8 relative; the adaptive loop
    reduces the distance."""
    from ngsxfem_tpu_torch.examples import lsetgeoms as tl
    from examples import lsetgeoms as jl

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rt = tl.run(geoms=("sphere", "torus"), nref=2, verbose=False, **CPU)
        rj = jl.run(geoms=("sphere", "torus"), nref=2, verbose=False)
    for g in rt:
        dt, dj = np.asarray(rt[g][0]), np.asarray(rj[g][0])
        assert np.abs(dt - dj).max() <= 1e-8 * np.abs(dj).max()
        assert dt[1] < dt[0]
