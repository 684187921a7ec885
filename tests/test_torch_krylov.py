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
