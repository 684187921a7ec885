"""Reference quadrature rules (host-side, float64 numpy).

Copied from ``ngsxfem_tpu/ops/gauss.py`` (importing that module would run
the JAX package's ``__init__``).  Simplex rules are conical-product (Duffy)
tensor Gauss rules, exact for all polynomials up to the requested total
degree.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def gauss_legendre_01(n: int):
    """n-point Gauss-Legendre rule on [0,1]; exact for degree <= 2n-1."""
    x, w = np.polynomial.legendre.leggauss(max(n, 1))
    return (0.5 * (x + 1.0)), (0.5 * w)


@lru_cache(maxsize=None)
def gauss_lobatto_01(n: int):
    """n-point Gauss-Lobatto rule on [0,1] (nodes include the endpoints),
    exact for degree <= 2n-3: the nodes of the nodal time finite elements
    (reference ``spacetime/SpaceTimeFE.hpp:50-97``)."""
    if n < 2:
        raise ValueError("Gauss-Lobatto needs n >= 2")
    if n == 2:
        x = np.array([-1.0, 1.0])
    else:
        # interior nodes: roots of P'_{n-1}, the eigenvalues of the
        # (n-2) x (n-2) Jacobi matrix of the (1,1) Jacobi polynomials
        k = np.arange(1, n - 2, dtype=np.float64)
        a = np.sqrt(k * (k + 2.0) / ((2.0 * k + 1.0) * (2.0 * k + 3.0)))
        J = np.diag(a, 1) + np.diag(a, -1)
        if J.shape[0] == 0:
            J = np.zeros((n - 2, n - 2))
        xi = np.linalg.eigvalsh(J)
        x = np.concatenate([[-1.0], np.sort(xi), [1.0]])
    # weights: w_i = 2 / (n(n-1) [P_{n-1}(x_i)]^2)
    Pnm1 = np.polynomial.legendre.Legendre.basis(n - 1)(x)
    w = 2.0 / (n * (n - 1) * Pnm1**2)
    return 0.5 * (x + 1.0), 0.5 * w


def _n_for_degree(p: int) -> int:
    """#Gauss points for exactness at total degree p."""
    return max(1, (p + 2) // 2)


@lru_cache(maxsize=None)
def rule_segm(order: int):
    """Rule on the unit segment [0,1]. Returns pts (n,1), w (n,)."""
    x, w = gauss_legendre_01(_n_for_degree(order))
    return x[:, None].copy(), w.copy()


@lru_cache(maxsize=None)
def rule_trig(order: int):
    """Rule on the unit triangle {x,y>=0, x+y<=1}; sum(w) = 1/2.

    Duffy map (xi, eta) -> (xi, eta*(1-xi)) with Jacobian (1-xi):
    monomial x^a y^b pulls back to xi-degree a+b+1 and eta-degree b.
    """
    nx = _n_for_degree(order + 1)
    ny = _n_for_degree(order)
    xi, wx = gauss_legendre_01(nx)
    eta, wy = gauss_legendre_01(ny)
    XI, ETA = np.meshgrid(xi, eta, indexing="ij")
    WX, WY = np.meshgrid(wx, wy, indexing="ij")
    x = XI
    y = ETA * (1.0 - XI)
    w = WX * WY * (1.0 - XI)
    pts = np.stack([x.ravel(), y.ravel()], axis=-1)
    return pts, w.ravel()


@lru_cache(maxsize=None)
def rule_tet(order: int):
    """Rule on the unit tetrahedron; sum(w) = 1/6."""
    nx = _n_for_degree(order + 2)
    ny = _n_for_degree(order + 1)
    nz = _n_for_degree(order)
    xi, wx = gauss_legendre_01(nx)
    eta, wy = gauss_legendre_01(ny)
    zeta, wz = gauss_legendre_01(nz)
    XI, ETA, ZETA = np.meshgrid(xi, eta, zeta, indexing="ij")
    WX, WY, WZ = np.meshgrid(wx, wy, wz, indexing="ij")
    x = XI
    y = ETA * (1.0 - XI)
    z = ZETA * (1.0 - XI) * (1.0 - ETA)
    w = WX * WY * WZ * (1.0 - XI) ** 2 * (1.0 - ETA)
    pts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=-1)
    return pts, w.ravel()


@lru_cache(maxsize=None)
def rule_quad(order: int):
    """Tensor rule on the unit square; sum(w) = 1."""
    n = _n_for_degree(order)
    x, w = gauss_legendre_01(n)
    X, Y = np.meshgrid(x, x, indexing="ij")
    WX, WY = np.meshgrid(w, w, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=-1)
    return pts, (WX * WY).ravel()


@lru_cache(maxsize=None)
def rule_hex(order: int):
    """Tensor rule on the unit cube; sum(w) = 1."""
    n = _n_for_degree(order)
    x, w = gauss_legendre_01(n)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    WX, WY, WZ = np.meshgrid(w, w, w, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)
    return pts, (WX * WY * WZ).ravel()


@lru_cache(maxsize=None)
def rule_point(order: int = 0):
    """0-dimensional rule (vertex evaluation); pts shape (1,0), w=[1]."""
    return np.zeros((1, 0)), np.ones((1,))


_RULES = {
    "point": rule_point,
    "segm": rule_segm,
    "trig": rule_trig,
    "quad": rule_quad,
    "tet": rule_tet,
    "hex": rule_hex,
}


def reference_rule(et: str, order: int):
    """Rule on the reference element of type `et`, exact to degree `order`."""
    return _RULES[et](int(max(order, 0)))


# dimension, simplex type and vertex count of each element type
ET_DIM = {"point": 0, "segm": 1, "trig": 2, "quad": 2, "tet": 3, "hex": 3}
SIMPLEX_OF_DIM = {0: "point", 1: "segm", 2: "trig", 3: "tet"}
ET_NVERT = {"point": 1, "segm": 2, "trig": 3, "quad": 4, "tet": 4, "hex": 8}
