"""The quadrature path of the flagship model against the JAX package.

``cut_poisson_elmats``, ``ghost_penalty_elmats`` and the
``UnfittedPoisson`` methods ``elmats``, ``gp_mats``, ``apply``, ``rhs`` and
``solve`` at nx <= 6, order 1 and 2, float64 on the CPU: equal to the
reference to 1e-12 (relative to the largest entry).  The reference
builds the cut rule on every element; the port splits uncut and cut
elements, which changes only the rounding.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from ngsxfem_tpu.models import poisson as jp
from ngsxfem_tpu_torch.models import poisson as tp

CASES = [(2, 6, 1), (3, 4, 1), (2, 5, 2), (3, 3, 2)]
_MODELS = {}


def _pair(dim, nx, order):
    key = (dim, nx, order)
    if key not in _MODELS:
        mj = jp.UnfittedPoisson(nx=nx, dim=dim, order=order, dtype=jnp.float64)
        mt = tp.UnfittedPoisson(nx=nx, dim=dim, order=order,
                                dtype=torch.float64, device="cpu")
        _MODELS[key] = (mj, mt)
    return _MODELS[key]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(a))


@pytest.mark.parametrize("dim,nx,order", CASES)
def test_element_kernels_match_jax(dim, nx, order):
    mj, mt = _pair(dim, nx, order)
    rng = np.random.default_rng(dim * 10 + order)
    els = mt.elements
    coords = mt.mesh.vertices_np[els]
    vals = rng.standard_normal(mt.mesh.nv)[els]
    Aj = jax.jit(lambda c, v: jp.cut_poisson_elmats(mj.et, order, c, v, 20.0))(
        jnp.asarray(coords), jnp.asarray(vals))
    At = tp.cut_poisson_elmats(mt.et, order, torch.as_tensor(coords),
                               torch.as_tensor(vals), 20.0)
    assert _rel(Aj, At.numpy()) <= 1e-12
    c1, c2 = coords[mt.gp_e1], coords[mt.gp_e2]
    Gj = jax.jit(lambda a, b: jp.ghost_penalty_elmats(mj.et, order, a, b,
                                                      0.1))(
        jnp.asarray(c1), jnp.asarray(c2))
    Gt = tp.ghost_penalty_elmats(mt.et, order, torch.as_tensor(c1),
                                 torch.as_tensor(c2), 0.1)
    assert _rel(Gj, Gt.numpy()) <= 1e-12
    assert _rel(Gj, mt.gp_mats(mt.vertices).numpy()) <= 1e-12
    fj = lambda p: 1 + p[..., 0] ** 2
    bj = jax.jit(lambda c, v: jp.cut_poisson_rhs_elvecs(mj.et, order, c, v,
                                                        fj))(
        jnp.asarray(coords), jnp.asarray(vals))
    bt = tp.cut_poisson_rhs_elvecs(mt.et, order, torch.as_tensor(coords),
                                   torch.as_tensor(vals), fj)
    assert _rel(bj, bt.numpy()) <= 1e-12


@pytest.mark.parametrize("dim,nx,order", CASES)
def test_model_methods_match_jax(dim, nx, order):
    mj, mt = _pair(dim, nx, order)
    Aj = jax.jit(mj.elmats)(mj.vertices, mj.lset)
    assert _rel(Aj, mt.elmats(mt.vertices, mt.lset).numpy()) <= 1e-12
    x = np.random.default_rng(order).standard_normal(mt.ndof)
    yj = jax.jit(mj.apply)(mj.vertices, mj.lset, jnp.asarray(x))
    yt = mt.apply(mt.vertices, mt.lset, torch.as_tensor(x))
    assert _rel(yj, yt.numpy()) <= 1e-12
    f = lambda p: 1 + p[..., 0] * p[..., 1]
    assert _rel(jax.jit(lambda v, l: mj.rhs(v, l, f))(mj.vertices, mj.lset),
                mt.rhs(mt.vertices, mt.lset, f).numpy()) <= 1e-12


@pytest.mark.parametrize("dim,nx,order", [(2, 4, 1), (2, 6, 1), (3, 3, 1),
                                          (3, 2, 2)])
def test_solve_matches_jax(dim, nx, order):
    """25 CG iterations (tol=0): x to 1e-12 relative, residual to 1e-12 of
    ||b||.  Sizes where 25 iterations converge, so that f64 rounding is not
    amplified beyond 1e-12 (at nx=5, order 2 the two x differ by ~1e-3
    after 25 iterations of an unconverged, ill-conditioned CG)."""
    mj, mt = _pair(dim, nx, order)
    xj, kj, rj = mj.solve(maxiter=25, tol=0.0)
    xt, kt, rt = mt.solve(maxiter=25, tol=0.0)
    bn = float(torch.linalg.vector_norm(
        mt.rhs(mt.vertices, mt.lset, lambda p: torch.ones_like(p[..., 0]))))
    assert int(kj) == kt == 25
    assert _rel(xj, xt.numpy()) <= 1e-12
    assert abs(float(rj) - float(rt)) <= 1e-12 * bn


def test_operator_is_symmetric_order2():
    """|u.Av - v.Au| / |u.Av| of the order-2 operator (the symmetry probe of
    bench.py:651-656), f64 and f32."""
    for dt, tol in ((torch.float64, 1e-13), (torch.float32, 1e-6)):
        m = tp.UnfittedPoisson(nx=4, dim=3, order=2, dtype=dt, device="cpu")
        u = torch.cos(torch.arange(m.ndof, dtype=dt))
        v = torch.sin(torch.arange(m.ndof, dtype=dt))
        op = m.operator(m.vertices, m.lset)
        act = m.active_dof_mask(m.lset)
        u, v = u * act, v * act
        uav, vau = float(u @ op(v)), float(v @ op(u))
        assert abs(uav - vau) <= tol * abs(uav)
