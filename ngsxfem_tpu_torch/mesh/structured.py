"""Structured mesh generators (host, numpy).

Counterpart of ``ngsxfem_tpu/mesh/structured.py`` (``ngsolve.meshes``'
``Make1DMesh`` / ``MakeStructured2DMesh`` / ``MakeStructured3DMesh``, with
the ``mapping`` of the unit box and the ``periodic`` identification of
opposite boundary facets).  Vertices are numbered lexicographically (x
slowest), which is what the lattice assembly of ``models/poisson.py``
relies on.

Boundary numbering (1-based, NGSolve-like), evaluated on the unit box
*before* ``mapping`` is applied:
  1D: 1=left, 2=right
  2D: 1=bottom (y=0), 2=right (x=1), 3=top (y=1), 4=left (x=0)
  3D: 1=back (y=0), 2=front (y=1), 3=left (x=0), 4=right (x=1),
      5=bottom (z=0), 6=top (z=1)
"""
from __future__ import annotations

import numpy as np

from .mesh import Mesh


_BC_NAMES_2D = {1: "bottom", 2: "right", 3: "top", 4: "left"}
_BC_NAMES_3D = {1: "back", 2: "front", 3: "left", 4: "right", 5: "bottom",
                6: "top"}


def _facet_bc_from_unitbox(mesh: Mesh, unit_vertices: np.ndarray, dim: int):
    """Assign bc ids to boundary facets from unit-box face membership
    (vectorized over the boundary facets)."""
    tol = 1e-12
    bc = np.zeros(mesh.nfacets, dtype=np.int32)
    bf = mesh.boundary_facets_np
    if len(bf) == 0:
        return bc
    vs = unit_vertices[mesh.facets_np[bf]]  # (B, nvf, dim)
    if dim == 1:
        bc[bf] = np.where(vs[:, :, 0].max(1) < tol, 1, 2)
        return bc
    lo = np.all(vs < tol, axis=1)          # (B, dim) all verts at axis-min
    hi = np.all(vs > 1 - tol, axis=1)      # (B, dim) all verts at axis-max
    if dim == 2:
        conds = [lo[:, 1], hi[:, 0], hi[:, 1], lo[:, 0]]
    else:
        conds = [lo[:, 1], hi[:, 1], lo[:, 0], hi[:, 0], lo[:, 2], hi[:, 2]]
    out = np.zeros(len(bf), dtype=np.int32)
    for bid in range(len(conds), 0, -1):   # first match wins
        out = np.where(conds[bid - 1], bid, out)
    bc[bf] = out
    return bc


def _with_bc(mesh, unit_vertices, names):
    mesh.bc_of_facet_np = _facet_bc_from_unitbox(mesh, unit_vertices,
                                                 mesh.dim)
    mesh.bc_names = names
    return mesh


def _mapped(verts, mapping):
    """Vertices mapped pointwise by ``mapping(x[, y[, z]]) -> tuple``."""
    if mapping is None:
        return verts
    return np.array([np.atleast_1d(mapping(*v)) for v in verts],
                    dtype=np.float64)


def Make1DMesh(n: int, mapping=None):
    verts = np.linspace(0.0, 1.0, n + 1)[:, None]
    elems = np.stack([np.arange(n), np.arange(n) + 1], axis=1).astype(np.int32)
    return _with_bc(Mesh("segm", _mapped(verts, mapping), elems), verts,
                    {1: "left", 2: "right"})


def _periodic_identify(m, unit_vertices, periodic):
    """Match opposite unit-box boundary facets for the axes named in
    ``periodic`` (e.g. "x", "xy"); fills ``m.periodic_facet_np`` and
    ``m.periodic_axes``."""
    if not periodic:
        return m
    d = unit_vertices.shape[1]
    bf = m.boundary_facets_np
    centers = unit_vertices[m.facets_np[bf]].mean(axis=1)  # (B, d)
    for ax, ch in enumerate("xyz"[:d]):
        if ch not in periodic:
            continue
        lo = np.abs(centers[:, ax]) < 1e-12
        hi = np.abs(centers[:, ax] - 1.0) < 1e-12
        key = np.round(np.delete(centers, ax, axis=1)
                       * 2.0**40).astype(np.int64)
        lom = {tuple(k): int(f) for k, f in zip(key[lo], bf[lo])}
        for k, f in zip(key[hi], bf[hi]):
            p = lom[tuple(k)]
            m.periodic_facet_np[p] = f
            m.periodic_facet_np[f] = p
    m.periodic_axes = periodic
    return m


def MakeStructured2DMesh(quads=True, nx=10, ny=10, mapping=None,
                         periodic=""):
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
    return _periodic_identify(
        _with_bc(Mesh("quad" if quads else "trig", _mapped(verts, mapping),
                      elems), verts, _BC_NAMES_2D), verts, periodic)


def MakeStructured3DMesh(hexes=True, nx=10, ny=10, nz=10, mapping=None,
                         periodic=""):
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
    return _periodic_identify(
        _with_bc(Mesh("hex" if hexes else "tet", _mapped(verts, mapping),
                      elems), verts, _BC_NAMES_3D), verts, periodic)
