"""Structure-of-arrays meshes: host tables.

Counterpart of ``ngsxfem_tpu/mesh/mesh.py:73-240``, host part only.  A mesh
is a set of flat numpy arrays (vertices ``(nv, d)``, element->vertex
``(ne, nvel)``, facet->vertex, facet<->element adjacency) built once on the
host.  It holds no tensor, so it takes no device: the models that run on a
device make their own tensor views of these tables once.
"""
from __future__ import annotations

import numpy as np

from ..ops.gauss import ET_DIM, ET_NVERT

# local facet -> local vertices, per element type (own convention, documented)
FACET_VERTS = {
    "segm": [(0,), (1,)],
    "trig": [(0, 1), (1, 2), (0, 2)],
    "quad": [(0, 1), (1, 2), (2, 3), (0, 3)],
    "tet": [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)],
    "hex": [
        (0, 1, 2, 3),
        (4, 5, 6, 7),
        (0, 1, 5, 4),
        (1, 2, 6, 5),
        (3, 2, 6, 7),
        (0, 3, 7, 4),
    ],
}


class Mesh:
    """A single-element-type unstructured mesh held as flat host arrays."""

    def __init__(self, et: str, vertices: np.ndarray, elements: np.ndarray):
        self.et = et
        self.dim = ET_DIM[et]
        self.nvel = ET_NVERT[et]
        self.vertices_np = np.asarray(vertices, dtype=np.float64)
        self.elements_np = np.asarray(elements, dtype=np.int32)
        self.nv = self.vertices_np.shape[0]
        self.ne = self.elements_np.shape[0]
        self._build_facets()

    def _build_facets(self):
        fv = np.array(FACET_VERTS[self.et], dtype=np.int32)  # (nfel, nvf)
        nfel, nvf = fv.shape
        from .native import build_facets as native_build

        out = native_build(self.elements_np, fv)
        if out is not None:
            self.facets_np, self.el2facet_np, self.facet2el_np, self.facet2elloc_np = out
            self.nfacets = self.facets_np.shape[0]
            self.boundary_facets_np = np.nonzero(
                self.facet2el_np[:, 1] < 0
            )[0].astype(np.int32)
            return
        # all facets with duplicates: (ne*nfel, nvf)
        allf = self.elements_np[:, fv.reshape(-1)].reshape(self.ne, nfel, nvf)
        key = np.sort(allf.reshape(-1, nvf), axis=1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        nf = uniq.shape[0]
        self.nfacets = nf
        # keep un-sorted vertex order of the first occurrence for orientation
        first = np.full(nf, -1, dtype=np.int64)
        flat = allf.reshape(-1, nvf)
        order = np.arange(flat.shape[0])
        # reverse iterate so first occurrence wins
        first[inv[::-1]] = order[::-1]
        self.facets_np = flat[first].astype(np.int32)
        self.el2facet_np = inv.reshape(self.ne, nfel).astype(np.int32)
        f2e = np.full((nf, 2), -1, dtype=np.int32)
        f2eloc = np.full((nf, 2), -1, dtype=np.int32)
        for e in range(self.ne):
            for lf in range(nfel):
                f = self.el2facet_np[e, lf]
                s = 0 if f2e[f, 0] < 0 else 1
                f2e[f, s] = e
                f2eloc[f, s] = lf
        self.facet2el_np = f2e
        self.facet2elloc_np = f2eloc
        self.boundary_facets_np = np.nonzero(f2e[:, 1] < 0)[0].astype(np.int32)

    def __repr__(self):
        return f"Mesh(et={self.et}, nv={self.nv}, ne={self.ne}, nfacets={self.nfacets})"


def geom_shapes(et: str, pts):
    """Vertex shape functions N (..., nv) at reference points pts (..., d)
    (host numpy; the reference's ``geom_shapes(..., xp=np)``)."""
    if et == "segm":
        x = pts[..., 0]
        return np.stack([1 - x, x], axis=-1)
    if et == "trig":
        x, y = pts[..., 0], pts[..., 1]
        return np.stack([1 - x - y, x, y], axis=-1)
    if et == "quad":
        x, y = pts[..., 0], pts[..., 1]
        return np.stack([(1 - x) * (1 - y), x * (1 - y), x * y, (1 - x) * y], axis=-1)
    if et == "tet":
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        return np.stack([1 - x - y - z, x, y, z], axis=-1)
    if et == "hex":
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        return np.stack(
            [
                (1 - x) * (1 - y) * (1 - z),
                x * (1 - y) * (1 - z),
                x * y * (1 - z),
                (1 - x) * y * (1 - z),
                (1 - x) * (1 - y) * z,
                x * (1 - y) * z,
                x * y * z,
                (1 - x) * y * z,
            ],
            axis=-1,
        )
    raise ValueError(et)
