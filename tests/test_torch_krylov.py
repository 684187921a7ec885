"""DIA operator and Krylov solvers of the PyTorch port against the JAX package.

The operator is the port's assembled flagship table at nx=8, handed to both
packages as numpy.  Tolerances: dia_matvec 1e-13 in f64; fixed-budget
cg(tol=0) rel 5e-5 in f32 (reduction-order roundoff, as
tests/test_pallas_cg.py:79-82); cg_ir's true f64 residual <= 1e-10 (bench.py
asserts the same).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ngsxfem_tpu.solvers import krylov as jax_krylov
from ngsxfem_tpu.solvers import sparse as jax_sparse
from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
from ngsxfem_tpu_torch.solvers import krylov, sparse

_CACHE = {}


def _flagship(dtype):
    if dtype not in _CACHE:
        m = UnfittedPoisson(nx=8, dim=3, order=1, dtype=dtype, device="cpu")
        st = m.dia_structure()
        V, _ = m.assemble_vals_lattice(m.vertices, m.lset, st)
        offs = st["offsets"]
        k0 = int(np.searchsorted(offs, 0))
        b = torch.as_tensor(np.where(m.active_dofs[st["perm_inv"]], 1.0, 0.0),
                            dtype=dtype)
        _CACHE[dtype] = (offs, V, b, k0)
    return _CACHE[dtype]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_dia_matvec_matches_reference():
    offs, V, _, _ = _flagship(torch.float64)
    x = np.random.default_rng(3).standard_normal(V.shape[1])
    yj = np.asarray(jax_sparse.dia_matvec(offs, jnp.asarray(V.numpy()),
                                          jnp.asarray(x)))
    yt = sparse.dia_matvec(offs, V, torch.as_tensor(x)).numpy()
    assert np.abs(yt - yj).max() <= 1e-13 * np.abs(yj).max()


def test_dia_matrix_from_numpy():
    offs, V, _, k0 = _flagship(torch.float64)
    A = sparse.DIAMatrix.from_numpy(offs, V.numpy(), device="cpu")
    Aj = jax_sparse.DIAMatrix(offs, jnp.asarray(V.numpy()))
    x = np.random.default_rng(4).standard_normal(V.shape[1])
    assert A.shape == Aj.shape and A.vals.dtype == torch.float64
    assert np.abs((A @ torch.as_tensor(x)).numpy()
                  - np.asarray(Aj @ jnp.asarray(x))).max() <= \
        1e-13 * np.abs(V.numpy()).max() * np.abs(x).max()
    assert torch.equal(A.diagonal(), V[k0])


@pytest.mark.parametrize("iters", [1, 12])
def test_cg_fixed_budget_matches_reference(iters):
    offs, V, b, k0 = _flagship(torch.float32)
    dinv = torch.where(V[k0].abs() > 1e-30, 1.0 / V[k0], 1.0)
    Vj, bj, dj = (jnp.asarray(t.numpy()) for t in (V, b, dinv))
    xj, kj, rj = jax_krylov.cg(lambda x: jax_sparse.dia_matvec(offs, Vj, x), bj,
                               M=lambda r: dj * r, maxiter=iters, tol=0.0)
    xt, kt, rt = krylov.cg(lambda x: sparse.dia_matvec(offs, V, x), b,
                           M=lambda r: dinv * r, maxiter=iters, tol=0.0)
    assert kt == int(kj) == iters
    assert _rel(xt.numpy(), xj) < 5e-5
    assert abs(float(rt) - float(rj)) <= 5e-5 * float(torch.linalg.vector_norm(b))


def test_cg_tolerance_path_matches_reference():
    offs, V, b, k0 = _flagship(torch.float64)
    Vj, bj = jnp.asarray(V.numpy()), jnp.asarray(b.numpy())
    Mj = jax_krylov.jacobi_preconditioner(Vj[k0])
    Mt = krylov.jacobi_preconditioner(V[k0])
    xj, kj, _ = jax_krylov.cg(lambda x: jax_sparse.dia_matvec(offs, Vj, x), bj,
                              M=Mj, maxiter=2000, tol=1e-8)
    xt, kt, rt = krylov.cg(lambda x: sparse.dia_matvec(offs, V, x), b, M=Mt,
                           maxiter=2000, tol=1e-8)
    assert abs(kt - int(kj)) <= 1 and kt < 2000
    assert float(rt) <= 1e-8 * float(torch.linalg.vector_norm(b))
    assert _rel(xt.numpy(), xj) < 1e-6


def test_jacobi_preconditioner_matches_reference():
    diag = np.array([2.0, 0.0, -4.0, 1e-31, 8.0])
    free = np.array([True, True, True, True, False])
    r = np.arange(1.0, 6.0)
    zj = jax_krylov.jacobi_preconditioner(jnp.asarray(diag), jnp.asarray(free))(
        jnp.asarray(r))
    zt = krylov.jacobi_preconditioner(torch.as_tensor(diag),
                                      torch.as_tensor(free))(torch.as_tensor(r))
    assert np.array_equal(zt.numpy(), np.asarray(zj))


def test_cg_ir_reaches_true_f64_residual():
    offs, V, b, k0 = _flagship(torch.float32)
    dinv = torch.where(V[k0].abs() > 1e-30, 1.0 / V[k0], 1.0)
    V64 = V.double()
    x64, res = krylov.cg_ir(lambda x: sparse.dia_matvec(offs, V, x),
                            lambda x: sparse.dia_matvec(offs, V64, x), b,
                            M=lambda r: dinv * r, outer=4, inner=120)
    b64 = b.double()
    true = torch.linalg.vector_norm(b64 - sparse.dia_matvec(offs, V64, x64))
    assert x64.dtype == torch.float64
    assert float(true) == pytest.approx(float(res), rel=1e-6, abs=1e-300)
    assert float(res) / float(torch.linalg.vector_norm(b64)) <= 1e-10


# -- MINRES and the solver wrappers --------------------------------------------

def _saddle():
    """The symmetric indefinite case of tests/test_stokes.py:24-48."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((12, 12))
    A = A + A.T + 14 * np.eye(12)
    B = rng.standard_normal((4, 12))
    K = np.block([[A, B.T], [B, np.zeros((4, 4))]])
    return K, rng.standard_normal(16)


@pytest.mark.parametrize("precond,tol", [(False, 1e-12), (True, 1e-11)])
def test_minres_matches_reference(precond, tol):
    """minres against the reference's on the saddle-point case: iterations
    within 1, solution to 1e-10 relative, both equal to the direct solve to
    the reference test's 1e-8.  Past the Krylov dimension (16) the residual
    estimate of the preconditioned solve moves with the rounding of the two
    implementations' dots and products: at 1e-12 they stop at 22 and 24
    iterations (solutions equal to 1e-12), so the iteration count is held
    at 1e-11 there, where they stop at 21 and 22."""
    K, b = _saddle()
    xref = np.linalg.solve(K, b)
    dinv = 1.0 / np.maximum(np.abs(np.diag(K)), 1e-2)
    Kj, Kt = jnp.asarray(K), torch.as_tensor(K)
    Mj = (lambda r: jnp.asarray(dinv) * r) if precond else None
    Mt = (lambda r: torch.as_tensor(dinv) * r) if precond else None
    for t in (tol, 1e-12):
        xj, kj, _ = jax_krylov.minres(lambda v: Kj @ v, jnp.asarray(b), M=Mj,
                                      maxiter=400, tol=t)
        xt, kt, rel = krylov.minres(lambda v: Kt @ v, torch.as_tensor(b),
                                    M=Mt, maxiter=400, tol=t)
        assert _rel(xt.numpy(), np.asarray(xj)) <= 1e-10
        assert np.abs(xt.numpy() - xref).max() < 1e-8
        assert float(rel) <= t
        if t == tol:
            assert abs(kt - int(kj)) <= 1, (kt, int(kj))
    if not precond:
        assert kt <= 16 + 1  # the Krylov dimension bound


def _poisson_system():
    """P1 Poisson with a Dirichlet boundary at nx=8 through both packages'
    forms: (port matrix, port load, free dofs, reference matrix and load)."""
    import ngsxfem_tpu as J
    import ngsxfem_tpu_torch as T

    out = []
    for N, kw in ((T, {"device": "cpu"}), (J, {})):
        mesh = N.MakeStructured2DMesh(quads=False, nx=8, ny=8)
        V = N.H1(mesh, order=1, dirichlet=[1, 2], **kw)
        u, v = V.TnT()
        a = N.BilinearForm(V)
        a += N.SymbolicBFI(form=N.grad(u) * N.grad(v) + u * v)
        a.Assemble()
        f = N.LinearForm(V)
        f += N.SymbolicLFI(form=(N.x * N.y + 1) * v)
        f.Assemble()
        out.append((a, f, V.FreeDofs()))
    return out


def test_cgsolver_takes_shims_and_bitarrays():
    """CGSolver(mat, freedofs=BitArray) * f.vec equals the "cg" inverse bit
    for bit and the reference's CGSolver to 1e-10."""
    (a, f, free), (aj, fj, freej) = _poisson_system()
    x = krylov.CGSolver(a.mat, freedofs=free, maxsteps=20 * a.mat.shape[0],
                        tol=1e-12) * f.vec
    x_inv = a.mat.Inverse(free, inverse="cg") * f.vec
    assert torch.equal(x, x_inv)
    xj = jax_krylov.CGSolver(aj.mat, freedofs=freej,
                             maxsteps=20 * aj.mat.shape[0], tol=1e-12) * fj.vec.data
    assert _rel(x.numpy(), np.asarray(xj)) <= 1e-10
    assert not x.numpy()[~free.np].any()


def test_minres_solver_with_bitarray():
    """MinResSolver(mat, freedofs=BitArray) * f.vec against the reference's
    MinResSolver (1e-10) and the host LU (1e-8), fixed dofs zero."""
    (a, f, free), (aj, fj, freej) = _poisson_system()
    x = krylov.MinResSolver(a.mat, freedofs=free, tol=1e-12) * f.vec
    xj = jax_krylov.MinResSolver(aj.mat, freedofs=freej, tol=1e-12) * fj.vec.data
    x_lu = a.mat.Inverse(free) * f.vec
    assert _rel(x.numpy(), np.asarray(xj)) <= 1e-10
    assert _rel(x.numpy(), x_lu.numpy()) <= 1e-8
    assert not x.numpy()[~free.np].any()
