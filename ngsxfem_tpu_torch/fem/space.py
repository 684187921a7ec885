"""Finite element spaces: host dof maps.

Counterpart of ``ngsxfem_tpu/fem/space.py:98-230``, host part only: a space
is its dof map ``el2dof_np (ne, ndl)`` and ``ndof``.  Global dof numbering
uses an *exact integer barycentric fingerprint* per Lagrange node (vertex ids
+ integer weights), deduplicated in first-appearance order by the native
topology library, exactly as the reference package numbers its dofs.
"""
from __future__ import annotations

import numpy as np

from ..mesh.mesh import Mesh, geom_shapes
from ..ops.gauss import ET_NVERT
from .basis import lagrange_element


def _node_fingerprints(mesh: Mesh, order: int):
    """Exact integer fingerprints of all element-local Lagrange nodes.

    Returns (keys (ne*ndl, 2*nv) int64, ndl).
    """
    et = mesh.et
    b = lagrange_element(et, order)
    nodes = b["nodes"]  # (ndl, d)
    nv = ET_NVERT[et]
    N = geom_shapes(et, nodes)  # (ndl, nv)
    k = max(order, 1)
    den = k ** (1 if et in ("segm", "trig", "tet") else mesh.dim)
    W = np.rint(N * den).astype(np.int64)  # exact integer weights
    assert np.allclose(W / den, N, atol=1e-9), "non-exact node weights"
    ndl = nodes.shape[0]
    ne = mesh.ne
    vids = mesh.elements_np[:, None, :].repeat(ndl, axis=1).astype(np.int64)  # (ne,ndl,nv)
    Wb = np.broadcast_to(W[None], (ne, ndl, nv)).copy()
    # null out vertex ids with zero weight, then sort pairs for canonical form
    vids = np.where(Wb > 0, vids, -1)
    comp = vids.reshape(-1, nv) * np.int64(den + 2) + Wb.reshape(-1, nv)
    ordr = np.argsort(comp, axis=-1)
    vs = np.take_along_axis(vids.reshape(-1, nv), ordr, axis=-1)
    ws = np.take_along_axis(Wb.reshape(-1, nv), ordr, axis=-1)
    keys = np.concatenate([vs, ws], axis=-1)  # (ne*ndl, 2nv)
    return keys, ndl


class H1:
    """Continuous Lagrange space of given order (cf. NGSolve H1), host dof
    map only.  Holds no tensor, so it takes no device."""

    def __init__(self, mesh: Mesh, order: int = 1):
        self.mesh = mesh
        self.order = int(order)
        keys, ndl = _node_fingerprints(mesh, self.order)
        from ..mesh.native import dedup_rows

        out = dedup_rows(keys)
        if out is not None:
            self.ndof, inv, _ = out
        else:
            uniq, inv = np.unique(keys, axis=0, return_inverse=True)
            self.ndof = uniq.shape[0]
        self.el2dof_np = inv.reshape(mesh.ne, ndl).astype(np.int32)

    def __repr__(self):
        return f"H1(order={self.order}, ndof={self.ndof})"
