"""Functional cut multigrid of the PyTorch port against the JAX package.

Host tables (``prolongation_coo_np``, ``coo_to_ell_np``, ``_if_block_struct``)
are held bitwise equal, apart from the prolongation values (1e-14: the
coarse basis is evaluated by numpy here, by XLA there).  One V-cycle
(``FunctionalELLMG.apply``) on the same f64 params matches to rel 1e-10,
with ``prepare`` and with ``prepare_host``.  The slice as a whole, the
port's version of tests/test_multigrid.py:41-115 (each package assembling
its own [4, 8] hierarchy in f64), takes the same number of MG-CG
iterations as JAX and gives x to rel 1e-8; the f32 ``prepare_host`` path
on [4, 8, 16] converges to 1e-6 in at most 20 iterations, as
tests/test_multigrid.py:118-165 asks of the reference.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ngsxfem_tpu.mesh.structured import MakeStructured2DMesh as JaxMesh2D
from ngsxfem_tpu.fem.space import H1 as JaxH1
from ngsxfem_tpu.models.poisson import UnfittedPoisson as JaxPoisson
from ngsxfem_tpu.solvers import krylov as jax_krylov
from ngsxfem_tpu.solvers import mg as jax_mg
from ngsxfem_tpu_torch.fem.space import H1
from ngsxfem_tpu_torch.mesh.structured import (MakeStructured2DMesh,
                                               MakeStructured3DMesh)
from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
from ngsxfem_tpu_torch.solvers import krylov, mg
from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix

_CACHE = {}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _level(P, nx, dtype):
    """Model, ELL structure, assembled ELL values (numpy) and interface
    mask (dofs of cut elements, active), as tests/test_multigrid.py builds a
    level."""
    key = (P.__module__, nx, str(dtype))
    if key not in _CACHE:
        kw = {} if P is JaxPoisson else {"device": "cpu"}
        m = P(nx=nx, dim=3, order=1, dtype=dtype, **kw)
        st = m.ell_structure()
        V, _ = m.assemble_vals_soa1(m.vertices, m.lset, st)
        ve = m.lset_np[m.mesh.elements_np]
        cut = (ve < 0).any(1) & (ve > 0).any(1)
        ifm = np.zeros(m.ndof, bool)
        ifm[m.space.el2dof_np[cut].ravel()] = True
        _CACHE[key] = (m, st, np.asarray(V), ifm & m.active_dofs)
    return _CACHE[key]


def _hierarchy(mod, P, nxs, dtype):
    levels = [_level(P, nx, dtype) for nx in nxs]
    prols = [mod.prolongation_coo_np(levels[i][0].space, levels[i + 1][0].space)
             for i in range(len(levels) - 1)]
    M = mod.FunctionalELLMG(
        [lv[1]["ell_cols"] for lv in levels], prols,
        if_masks=[None] + [lv[3] for lv in levels[1:]], if_iters=10,
        active_masks=[lv[0].active_dofs for lv in levels])
    return levels, prols, M


def _spaces(dim):
    if dim == 3:
        return (JaxPoisson(nx=4, dim=3, dtype=jnp.float64).space,
                JaxPoisson(nx=8, dim=3, dtype=jnp.float64).space,
                H1(MakeStructured3DMesh(hexes=False, nx=4, ny=4, nz=4)),
                H1(MakeStructured3DMesh(hexes=False, nx=8, ny=8, nz=8)))
    return (JaxH1(JaxMesh2D(quads=False, nx=4, ny=4), order=2),
            JaxH1(JaxMesh2D(quads=False, nx=8, ny=8), order=2),
            H1(MakeStructured2DMesh(quads=False, nx=4, ny=4), order=2),
            H1(MakeStructured2DMesh(quads=False, nx=8, ny=8), order=2))


@pytest.mark.parametrize("dim", [3, 2])
def test_prolongation_and_ell_tables_match_reference(dim):
    jc, jf, tc, tf = _spaces(dim)
    pj = jax_mg.prolongation_coo_np(jc, jf)
    pt = mg.prolongation_coo_np(tc, tf)
    assert pt[3] == pj[3]
    for a, b in zip(pt[:2], pj[:2]):
        assert np.array_equal(a, b)
    assert pt[2].dtype == pj[2].dtype
    assert np.abs(pt[2] - pj[2]).max() <= 1e-14
    # P and R = P^T as padded ELL tables
    for args_t, args_j in (((pt[0], pt[1], pt[2], pt[3]),
                            (pj[0], pj[1], pj[2], pj[3])),
                           ((pt[1], pt[0], pt[2], pt[3][::-1]),
                            (pj[1], pj[0], pj[2], pj[3][::-1]))):
        ct, vt = mg.coo_to_ell_np(*args_t)
        cj, vj = jax_mg.coo_to_ell_np(*args_j)
        assert ct.dtype == cj.dtype and np.array_equal(ct, cj)
        assert np.abs(vt - vj).max() <= 1e-14


def test_prolongation_matrix_matches_reference():
    jc, jf, tc, tf = _spaces(3)
    Pj = jax_mg.prolongation_matrix(jc, jf)
    Pt = mg.prolongation_matrix(tc, tf, dtype=torch.float64, device="cpu")
    assert Pt.shape == Pj.shape and Pt.vals.dtype == torch.float64
    x = np.random.default_rng(0).standard_normal(Pt.shape[1])
    assert _rel((Pt @ torch.as_tensor(x)).numpy(),
                np.asarray(Pj @ jnp.asarray(x))) <= 1e-14
    y = np.random.default_rng(1).standard_normal(Pt.shape[0])
    assert _rel((Pt.T @ torch.as_tensor(y)).numpy(),
                np.asarray(Pj.T @ jnp.asarray(y))) <= 1e-14


def test_mesh_hierarchy_and_quad_prolongation():
    """The hierarchy helper, and the quad/hex prolongation (batched Newton
    inversion of the multilinear map) equal to the JAX package's to 1e-12
    on mapped meshes, orders 1 and 2."""
    from ngsxfem_tpu.mesh.structured import MakeStructured3DMesh as JaxMesh3D

    meshes = mg.mesh_hierarchy(
        lambda n: MakeStructured2DMesh(quads=False, nx=n, ny=n), 2, 3)
    assert [m.ne for m in meshes] == [8, 32, 128]
    m2 = lambda a, b: (a + 0.1 * a * b, b)
    m3 = lambda a, b, c: (a + 0.1 * a * b, b, c)
    pairs = [(lambda n: JaxMesh2D(quads=True, nx=n, ny=n, mapping=m2),
              lambda n: MakeStructured2DMesh(quads=True, nx=n, ny=n,
                                             mapping=m2), (3, 6)),
             (lambda n: JaxMesh3D(hexes=True, nx=n, ny=n, nz=n, mapping=m3),
              lambda n: MakeStructured3DMesh(hexes=True, nx=n, ny=n, nz=n,
                                             mapping=m3), (2, 4))]
    for jm, tm, (nc, nf) in pairs:
        for order in (1, 2):
            pj = jax_mg.prolongation_coo_np(JaxH1(jm(nc), order=order),
                                            JaxH1(jm(nf), order=order))
            pt = mg.prolongation_coo_np(H1(tm(nc), order=order),
                                        H1(tm(nf), order=order))
            assert pt[3] == pj[3]
            assert np.array_equal(pt[0], pj[0]) and np.array_equal(pt[1],
                                                                   pj[1])
            assert np.abs(pt[2] - pj[2]).max() <= 1e-12


@pytest.mark.parametrize("kind", ["compress", "xfe"])
def test_prolongation_masked_spaces_match_reference(kind):
    """Masked spaces (``Compress``, ``XFESpace``): inactive el2dof slots
    point at dof 0 and must be dropped, for the fine nodes and the coarse
    weights, as the JAX package drops them.  2D trigs, nx 4 -> 8, the
    circle r=0.6: dense matrices equal to 1e-14."""
    import ngsxfem_tpu as J
    import ngsxfem_tpu_torch as T

    def space(N, nx, **kw):
        m = N.MakeStructured2DMesh(quads=False, nx=nx, ny=nx,
                                   mapping=lambda a, b: (2 * a - 1, 2 * b - 1))
        V = N.H1(m, order=1, **kw)
        g = N.GridFunction(N.H1(m, order=1, **kw))
        N.InterpolateToP1(N.sqrt(N.x * N.x + N.y * N.y) - 0.6, g)
        ci = N.CutInfo(m, g)
        if kind == "compress":
            return N.Compress(V, N.GetDofsOfElements(
                V, ci.GetElementsOfType(N.HASNEG)))
        return N.XFESpace(V, ci)

    Pj = jax_mg.prolongation_matrix(space(J, 4), space(J, 8))
    Pt = mg.prolongation_matrix(space(T, 4, device="cpu"),
                                space(T, 8, device="cpu"), device="cpu")
    dj = np.asarray(Pj.to_scipy().todense())
    assert Pt.shape == Pj.shape
    assert np.abs(Pt.todense().numpy() - dj).max() <= 1e-14


@pytest.mark.parametrize("dim", [3, 2])
def test_if_block_struct_matches_reference(dim):
    if dim == 3:
        m = UnfittedPoisson(nx=8, dim=3, dtype=torch.float64, device="cpu")
    else:
        m = UnfittedPoisson(nx=12, dim=2, dtype=torch.float64, device="cpu")
    st = m.ell_structure()
    ve = m.lset_np[m.mesh.elements_np]
    cut = (ve < 0).any(1) & (ve > 0).any(1)
    ifm = np.zeros(m.ndof, bool)
    ifm[m.space.el2dof_np[cut].ravel()] = True
    ifm &= m.active_dofs
    out_t = mg._if_block_struct(st["ell_cols"], ifm, st["K"])
    out_j = jax_mg._if_block_struct(st["ell_cols"], ifm, st["K"])
    for a, b in zip(out_t, out_j):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    empty_t = mg._if_block_struct(st["ell_cols"], np.zeros(m.ndof, bool), 1)
    empty_j = jax_mg._if_block_struct(st["ell_cols"], np.zeros(m.ndof, bool), 1)
    for a, b in zip(empty_t, empty_j):
        assert a.dtype == b.dtype and a.shape == b.shape


@pytest.mark.parametrize("prep", ["prepare", "prepare_host"])
def test_vcycle_matches_reference(prep):
    """One V-cycle on the same f64 params (the JAX levels' numpy tables)."""
    levels, _, Mj = _hierarchy(jax_mg, JaxPoisson, (4, 8), jnp.float64)
    _, _, Mt = _hierarchy(mg, JaxPoisson, (4, 8), jnp.float64)
    vals = [lv[2] for lv in levels]
    ppj = getattr(Mj, prep)(Mj.params(vals, dtype=jnp.float64))
    ppt = getattr(Mt, prep)(Mt.params(vals, dtype=torch.float64, device="cpu"))
    b = np.random.default_rng(2).standard_normal(levels[-1][0].ndof)
    zj = np.asarray(Mj.apply(ppj, jnp.asarray(b)))
    zt = Mt.apply(ppt, torch.as_tensor(b))
    assert zt.dtype == torch.float64
    assert _rel(zt.numpy(), zj) <= 1e-10


def test_mg_cg_matches_reference_f64():
    """The ELL slice end to end in f64: each package builds its own [4, 8]
    hierarchy (ell_structure, assemble_vals_soa1, prolongation,
    FunctionalELLMG + prepare) and runs MG-preconditioned CG to 1e-8."""
    lj, _, Mj = _hierarchy(jax_mg, JaxPoisson, (4, 8), jnp.float64)
    lt, _, Mt = _hierarchy(mg, UnfittedPoisson, (4, 8), torch.float64)
    ppj = Mj.prepare(Mj.params([lv[2] for lv in lj], dtype=jnp.float64))
    ppt = Mt.prepare(Mt.params([lv[2] for lv in lt], dtype=torch.float64,
                               device="cpu"))
    mj, stj, vj, _ = lj[-1]
    cols = jnp.asarray(stj["ell_cols"])
    bj = jnp.where(jnp.asarray(mj.active_dofs), 1.0, 0.0)
    xj, kj, rj = jax_krylov.cg(lambda x: jnp.sum(jnp.asarray(vj) * x[cols], 1),
                               bj, M=lambda r: Mj.apply(ppj, r), maxiter=60,
                               tol=1e-8)
    mt, stt, vt, _ = lt[-1]
    A = ELLMatrix.from_numpy(stt["ell_cols"], vt, device="cpu")
    bt = torch.as_tensor(np.where(mt.active_dofs, 1.0, 0.0))
    xt, kt, rt = krylov.cg(A.matvec, bt, M=lambda r: Mt.apply(ppt, r),
                           maxiter=60, tol=1e-8)
    assert kt == int(kj) < 60
    assert float(rt) <= 1e-8 * float(torch.linalg.vector_norm(bt))
    assert _rel(xt.numpy(), np.asarray(xj)) <= 1e-8


def test_mg_cg_f32_prepare_host():
    levels, _, M = _hierarchy(mg, UnfittedPoisson, (4, 8, 16), torch.float32)
    pp = M.prepare_host(M.params([lv[2] for lv in levels],
                                 dtype=torch.float32, device="cpu"))
    assert pp["ainv0"].dtype == torch.float32 and pp["chol0"] is None
    m, st, V, _ = levels[-1]
    A = ELLMatrix.from_numpy(st["ell_cols"], V, device="cpu")
    b = torch.as_tensor(np.where(m.active_dofs, 1.0, 0.0), dtype=torch.float32)
    x, k, res = krylov.cg(A.matvec, b, M=lambda r: M.apply(pp, r), maxiter=60,
                          tol=1e-6)
    assert float(res) <= 1e-6 * float(torch.linalg.vector_norm(b)) * 1.5
    assert k <= 20, k
