"""Finite element spaces: dof maps, and boolean mark arrays.

Counterpart of ``ngsxfem_tpu/fem/space.py:24-230``: ``BitArray`` (host
boolean marks with NGSolve-like set algebra) and ``H1``, whose host dof map
is ``el2dof_np (ne, ndl)`` and ``ndof``, with a device view ``el2dof``.
Global dof numbering uses an *exact integer barycentric fingerprint* per
Lagrange node (vertex ids + integer weights), deduplicated in
first-appearance order by the native topology library, exactly as the
reference package numbers its dofs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..mesh.mesh import Mesh, geom_shapes
from ..ops.gauss import ET_NVERT
from .basis import lagrange_element


class BitArray:
    """Boolean mark array (host numpy) with NGSolve-like set algebra."""

    def __init__(self, data):
        self.a = np.asarray(data, dtype=bool)

    def __and__(self, o):
        return BitArray(self.a & _arr(o))

    def __or__(self, o):
        return BitArray(self.a | _arr(o))

    def __invert__(self):
        return BitArray(~self.a)

    def __iand__(self, o):
        self.a &= _arr(o)
        return self

    def __ior__(self, o):
        self.a |= _arr(o)
        return self

    def __getitem__(self, i):
        return self.a[i]

    def __setitem__(self, i, v):
        self.a[i] = v

    def __len__(self):
        return len(self.a)

    def __iter__(self):
        return iter(self.a)

    def NumSet(self):
        return int(self.a.sum())

    def Set(self, i=None):
        if i is None:
            self.a[:] = True
        else:
            self.a[i] = True

    def Clear(self, i=None):
        if i is None:
            self.a[:] = False
        else:
            self.a[i] = False

    @property
    def np(self):
        return self.a

    def __repr__(self):
        return f"BitArray({self.a.sum()}/{len(self.a)} set)"


def _arr(o):
    return o.a if isinstance(o, BitArray) else np.asarray(o, dtype=bool)


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
    """Continuous Lagrange space of given order (cf. NGSolve H1).

    The dof map is host numpy (``el2dof_np``) and so are the dof
    representatives ``dof_rep_elem``/``dof_rep_local``/``dof_rep_ref`` (an
    element holding each dof and the dof's reference node there, for nodal
    interpolation).  ``el2dof`` is its int64 view on ``device``, made on
    first use: the card unless the space was given ``device="cpu"``, and
    without a card and without that argument it raises then."""

    def __init__(self, mesh: Mesh, order: int = 1, device=None):
        self.mesh = mesh
        self.order = int(order)
        self._device = device
        keys, ndl = _node_fingerprints(mesh, self.order)
        from ..mesh.native import dedup_rows

        out = dedup_rows(keys)
        if out is not None:
            self.ndof, inv, first = out
        else:
            uniq, first, inv = np.unique(keys, axis=0, return_index=True,
                                         return_inverse=True)
            self.ndof = uniq.shape[0]
        self.el2dof_np = inv.reshape(mesh.ne, ndl).astype(np.int32)
        b = lagrange_element(mesh.et, self.order)
        first = np.asarray(first)
        self.dof_rep_elem = (first // ndl).astype(np.int32)
        self.dof_rep_local = (first % ndl).astype(np.int32)
        self.dof_rep_ref = b["nodes"][self.dof_rep_local]
        self._el2dof = {}

    @property
    def device(self):
        return resolve_device(self._device)

    @property
    def el2dof(self):
        """(ne, ndl) int64 dof map on the space's device."""
        return self.el2dof_on(self.device)

    def el2dof_on(self, device):
        """(ne, ndl) int64 dof map on ``device``, made once per device."""
        key = str(torch.device(device))
        if key not in self._el2dof:
            self._el2dof[key] = torch.as_tensor(
                self.el2dof_np, dtype=torch.int64, device=device)
        return self._el2dof[key]

    def __repr__(self):
        return f"H1(order={self.order}, ndof={self.ndof})"
