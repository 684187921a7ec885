"""Structured mesh generators (host, numpy).

Counterpart of ``ngsxfem_tpu/mesh/structured.py`` (``ngsolve.meshes``'
``Make1DMesh`` / ``MakeStructured2DMesh`` / ``MakeStructured3DMesh``, with
the ``mapping`` of the unit box) without the ``periodic`` option and the
boundary-condition ids, which nothing ported reads yet.  Vertices are
numbered lexicographically (x slowest), which is what the lattice assembly
of ``models/poisson.py`` relies on.
"""
from __future__ import annotations

import numpy as np

from .mesh import Mesh


def _mapped(verts, mapping):
    """Vertices mapped pointwise by ``mapping(x[, y[, z]]) -> tuple``."""
    if mapping is None:
        return verts
    return np.array([np.atleast_1d(mapping(*v)) for v in verts],
                    dtype=np.float64)


def Make1DMesh(n: int, mapping=None):
    verts = np.linspace(0.0, 1.0, n + 1)[:, None]
    elems = np.stack([np.arange(n), np.arange(n) + 1], axis=1).astype(np.int32)
    return Mesh("segm", _mapped(verts, mapping), elems)


def MakeStructured2DMesh(quads=True, nx=10, ny=10, mapping=None):
    xs = np.linspace(0.0, 1.0, nx + 1)
    ys = np.linspace(0.0, 1.0, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel()], axis=1)
    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()
    v00 = I * (ny + 1) + J
    v10 = (I + 1) * (ny + 1) + J
    v11 = (I + 1) * (ny + 1) + J + 1
    v01 = I * (ny + 1) + J + 1
    if quads:
        elems = np.stack([v00, v10, v11, v01], axis=1).astype(np.int32)
    else:
        # split each cell along the (v00,v11) diagonal
        t1 = np.stack([v00, v10, v11], axis=1)
        t2 = np.stack([v00, v11, v01], axis=1)
        elems = np.concatenate([t1[:, None], t2[:, None]],
                               axis=1).reshape(-1, 3).astype(np.int32)
    return Mesh("quad" if quads else "trig", _mapped(verts, mapping), elems)


def MakeStructured3DMesh(hexes=True, nx=10, ny=10, nz=10, mapping=None):
    xs = np.linspace(0.0, 1.0, nx + 1)
    ys = np.linspace(0.0, 1.0, ny + 1)
    zs = np.linspace(0.0, 1.0, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()

    def vid(di, dj, dk):
        return ((I + di) * (ny + 1) + (J + dj)) * (nz + 1) + (K + dk)

    # hex vertex order (0,0,0),(1,0,0),(1,1,0),(0,1,0), then z+1
    c = np.stack([
        vid(0, 0, 0), vid(1, 0, 0), vid(1, 1, 0), vid(0, 1, 0),
        vid(0, 0, 1), vid(1, 0, 1), vid(1, 1, 1), vid(0, 1, 1),
    ], axis=1)
    if hexes:
        elems = c.astype(np.int32)
    else:
        # Kuhn 6-tet split of the cell (all share diagonal c0-c6)
        kuhn = np.array([(0, 1, 2, 6), (0, 1, 5, 6), (0, 3, 2, 6),
                         (0, 3, 7, 6), (0, 4, 5, 6), (0, 4, 7, 6)])
        elems = c[:, kuhn].reshape(-1, 4).astype(np.int32)
    return Mesh("hex" if hexes else "tet", _mapped(verts, mapping), elems)
