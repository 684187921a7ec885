"""The whole flagship slice of the PyTorch port against the JAX flagship.

JAX side, as bench.py:195-266 builds it: ``UnfittedPoisson`` ->
``dia_structure`` -> ``assemble_vals_lattice`` -> ``krylov.cg`` on
``dia_matvec`` with the Jacobi preconditioner.  Port side: the same path,
built from its own state, ending in ``dia_cg_fused`` on the CPU.  nx=8; f64
for 50 iterations to rel 1e-9, f32 for 12 iterations to rel 5e-5
(reduction-order roundoff, as tests/test_pallas_cg.py:79-82).  The residual
difference is measured against ||b||, as tests/test_pallas_cg.py:82 does: 50
f64 iterations at nx=8 drive the residual itself down to roundoff (~1e-23).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ngsxfem_tpu.models.poisson import UnfittedPoisson as JaxPoisson
from ngsxfem_tpu.solvers.krylov import cg as jax_cg
from ngsxfem_tpu.solvers.sparse import dia_matvec as jax_dia_matvec
from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
from ngsxfem_tpu_torch.solvers.dia_cg import dia_cg_fused

NX = 8


def _jax_flagship(dtype, iters):
    m = JaxPoisson(nx=NX, dim=3, order=1, dtype=dtype)
    st = m.dia_structure()
    offs = st["offsets"]
    k0 = int(np.searchsorted(offs, 0))
    V, ncut = m.assemble_vals_lattice(m.vertices, m.lset, st)
    b = jnp.asarray(np.where(m.active_dofs[st["perm_inv"]], 1.0, 0.0),
                    dtype=dtype)
    dinv = jnp.where(jnp.abs(V[k0]) > 1e-30, 1.0 / V[k0], 1.0)
    x, _, res = jax_cg(lambda v: jax_dia_matvec(offs, V, v), b,
                       M=lambda r: dinv * r, maxiter=iters, tol=0.0)
    return np.asarray(x), float(res), int(ncut), float(jnp.linalg.norm(b))


def _port_flagship(dtype, iters):
    m = UnfittedPoisson(nx=NX, dim=3, order=1, dtype=dtype, device="cpu")
    st = m.dia_structure()
    offs = st["offsets"]
    k0 = int(np.searchsorted(offs, 0))
    V, ncut = m.assemble_vals_lattice(m.vertices, m.lset, st)
    b = torch.as_tensor(np.where(m.active_dofs[st["perm_inv"]], 1.0, 0.0),
                        dtype=dtype)
    dinv = torch.where(V[k0].abs() > 1e-30, 1.0 / V[k0], 1.0)
    x, res = dia_cg_fused(offs, V, b, dinv, iters)
    return x.numpy(), float(res), int(ncut)


@pytest.mark.parametrize("prec,iters,tol", [("f64", 50, 1e-9),
                                            ("f32", 12, 5e-5)])
def test_slice_matches_jax_flagship(prec, iters, tol):
    jdt, tdt = {"f64": (jnp.float64, torch.float64),
                "f32": (jnp.float32, torch.float32)}[prec]
    xj, rj, nj, bn = _jax_flagship(jdt, iters)
    xt, rt, nt = _port_flagship(tdt, iters)
    assert nt == nj
    assert xt.dtype == xj.dtype
    assert np.linalg.norm(xt - xj) <= tol * np.linalg.norm(xj)
    assert abs(rt - rj) <= tol * bn
