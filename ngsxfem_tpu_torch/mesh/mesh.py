"""Structure-of-arrays meshes: host tables and batched geometry maps.

Counterpart of ``ngsxfem_tpu/mesh/mesh.py``.  A mesh is a set of flat numpy
arrays (vertices ``(nv, d)``, element->vertex ``(ne, nvel)``, facet->vertex,
facet<->element adjacency) built once on the host.  It takes no device:
``device_view`` makes (once per device and dtype) the vertex and element
tensors that the quadrature evaluates geometry from.  The geometry maps
(``geom_shapes``, ``geom_dshapes``, ``map_points``, ``det_and_inv``) work on
batched tensors; ``geom_shapes`` also on numpy arrays for host setup.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import torch_dtype
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

FACET_ET = {"segm": "point", "trig": "segm", "quad": "segm", "tet": "trig", "hex": "quad"}

# local edges (1D sub-entities)
EDGE_VERTS = {
    "segm": [(0, 1)],
    "trig": [(0, 1), (1, 2), (0, 2)],
    "quad": [(0, 1), (1, 2), (2, 3), (0, 3)],
    "tet": [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
    "hex": [
        (0, 1), (1, 2), (2, 3), (0, 3),
        (4, 5), (5, 6), (6, 7), (4, 7),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ],
}

# element types whose geometry map is affine (constant Jacobian)
SIMPLICES = ("segm", "trig", "tet")


class Region:
    """A named element subset of a mesh (NGSolve ``Region`` analog, VOL
    only): the result of ``mesh.Materials(pattern)``.  Carries the element
    mask (host numpy) and the matched material names; it serves as
    ``definedon=`` of ``Integrate`` and of the integrators, and as an
    element mark array wherever one is taken."""

    def __init__(self, mesh, mask, names):
        self.mesh = mesh
        self.mask = np.asarray(mask, dtype=bool)
        self.names = tuple(names)

    def VB(self):
        return "VOL"

    def Mask(self):
        return self.mask

    def __repr__(self):
        return f"Region(VOL, {'|'.join(self.names)})"


class Mesh:
    """A single-element-type unstructured mesh held as flat host arrays.

    ``bc_of_facet_np`` holds a boundary-condition id per facet (1-based like
    NGSolve, 0 on interior facets; every boundary facet gets 1 unless
    ``bc_of_facet`` says otherwise) and ``bc_names`` their names;
    ``mat_of_el_np`` a material id per element (1-based, all 1 unless
    ``mat_of_el`` says otherwise) and ``mat_names`` their names;
    ``periodic_facet_np`` the partner of each boundary facet on the
    opposite periodic side (-1 where there is none; set by
    ``MakeStructured*DMesh(periodic=...)``, which names the axes in
    ``periodic_axes``).  ``Mesh(other_mesh)`` returns ``other_mesh``
    itself, so the reference idiom ``Mesh(geo.GenerateMesh(maxh=...))``
    works with ``SplineGeometry``."""

    def __new__(cls, et=None, *args, **kwargs):
        if isinstance(et, Mesh) and not args and not kwargs:
            return et
        return super().__new__(cls)

    def __init__(self, et: str, vertices: np.ndarray = None,
                 elements: np.ndarray = None, bc_of_facet=None,
                 bc_names=None, mat_of_el=None, mat_names=None):
        if isinstance(et, Mesh):
            return  # passthrough: already constructed
        self.et = et
        self.dim = ET_DIM[et]
        self.nvel = ET_NVERT[et]
        self.vertices_np = np.asarray(vertices, dtype=np.float64)
        self.elements_np = np.asarray(elements, dtype=np.int32)
        self.nv = self.vertices_np.shape[0]
        self.ne = self.elements_np.shape[0]
        self._build_facets()
        if bc_of_facet is None:
            bc_of_facet = np.where(self.facet2el_np[:, 1] < 0, 1, 0)
        self.bc_of_facet_np = np.asarray(bc_of_facet, dtype=np.int32)
        self.bc_names = bc_names or {}
        if mat_of_el is None:
            mat_of_el = np.ones(self.ne, dtype=np.int32)
        self.mat_of_el_np = np.asarray(mat_of_el, dtype=np.int32)
        if self.mat_of_el_np.shape != (self.ne,):
            raise ValueError("mat_of_el must be (ne,)")
        self.mat_names = dict(mat_names) if mat_names else {}
        # consumed by the facet set algebra (GetFacetsWithNeighborTypes /
        # GetElementsWithNeighborFacets, the reference's GetPeriodicFacet
        # in xfem/cutinfo.cpp:226-235) and by Periodic spaces
        self.periodic_facet_np = np.full(self.nfacets, -1, dtype=np.int64)
        self.periodic_axes = ""
        self._views = {}
        self._host_tables = {}  # host tables made lazily from the arrays
        # deformation slot (set by SetDeformation): a GridFunction of a
        # vector space, or None.  Every evaluation context inherits it.
        self.deformation = None
        self._version = 0  # bumped on Refine and on (un)setting a deformation

    def material_ids(self):
        """Ascending material ids: every id carried by an element and every
        id declared in ``mat_names``."""
        ids = set(int(i) for i in np.unique(self.mat_of_el_np))
        return sorted(ids | set(int(i) for i in self.mat_names))

    def GetMaterials(self):
        """Material names in ascending id order (unnamed ids get
        ``"mat<i>"``), NGSolve ``mesh.GetMaterials()`` analog; includes
        declared-but-empty materials."""
        return tuple(self.mat_names.get(i, f"mat{i}")
                     for i in self.material_ids())

    def Materials(self, pattern):
        """Element :class:`Region` of the materials whose name fully
        matches the regex ``pattern`` (NGSolve semantics; ``"a|b"``
        unions)."""
        import re

        names = {i: self.mat_names.get(i, f"mat{i}")
                 for i in self.material_ids()}
        sel = [i for i, nm in names.items() if re.fullmatch(pattern, nm)]
        mask = np.isin(self.mat_of_el_np, np.asarray(sel, dtype=np.int32))
        return Region(self, mask, [names[i] for i in sel])

    def GetBoundaries(self):
        """Boundary-condition names in ascending id order (``"bc<i>"`` for
        unnamed ids), NGSolve ``mesh.GetBoundaries()`` analog."""
        ids = np.unique(self.bc_of_facet_np[self.boundary_facets_np])
        return tuple(self.bc_names.get(int(i), f"bc{int(i)}")
                     for i in ids if i > 0)

    def device_view(self, device, dtype):
        """(vertices (nv, d) of ``dtype``, torch's or numpy's name for it;
        elements (ne, nvel) int64) on ``device``, made once per device and
        dtype."""
        dtype = torch_dtype(dtype)
        key = (str(torch.device(device)), dtype)
        view = self._views.get(key)
        if view is None:
            view = (torch.as_tensor(self.vertices_np, dtype=dtype, device=device),
                    torch.as_tensor(self.elements_np, dtype=torch.int64,
                                    device=device))
            self._views[key] = view
        return view

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

    # -- refinement ----------------------------------------------------------
    def Refine(self, marks=None):
        """Refine the marked elements in place (every element when no marks
        are given and none are stored by ``SetRefinementFlags``): trig
        meshes by longest-edge red/green/blue subdivision, tet meshes by
        Rivara bisection, both with a conformity closure; quad/hex meshes
        uniformly only (``mesh/refine.py``).  The mesh's device views and
        cached geometry are dropped, its deformation unset and its
        ``_version`` bumped: spaces and GridFunctions built before must be
        rebuilt."""
        from .refine import refine_mesh

        if marks is None:
            marks = getattr(self, "_refine_marks", None)
        return refine_mesh(self, marks)

    def SetRefinementFlags(self, marks):
        """Store per-element refinement flags for the next ``Refine()``."""
        self._refine_marks = np.asarray(
            marks.np if hasattr(marks, "np") else marks, dtype=bool)

    def _drop_caches(self):
        """Forget every table made lazily from the mesh's arrays: the device
        views and the host tables."""
        self._views = {}
        self._host_tables = {}

    # -- deformation -------------------------------------------------------
    def SetDeformation(self, deformation):
        """Apply a (vector) GridFunction as mesh deformation: the geometry
        map becomes x + deformation(x) in every evaluation context (the
        reference's ``mesh.SetDeformation`` after lsetcurving)."""
        self.deformation = deformation
        self._version += 1

    def UnsetDeformation(self):
        self.deformation = None
        self._version += 1

    def __repr__(self):
        return f"Mesh(et={self.et}, nv={self.nv}, ne={self.ne}, nfacets={self.nfacets})"


def _stack(arrs, axis):
    if torch.is_tensor(arrs[0]):
        return torch.stack(arrs, dim=axis)
    return np.stack(arrs, axis=axis)


def geom_shapes(et: str, pts):
    """Vertex shape functions N (..., nv) at reference points pts (..., d),
    on numpy arrays or tensors."""
    if et == "segm":
        x = pts[..., 0]
        return _stack([1 - x, x], -1)
    if et == "trig":
        x, y = pts[..., 0], pts[..., 1]
        return _stack([1 - x - y, x, y], -1)
    if et == "quad":
        x, y = pts[..., 0], pts[..., 1]
        return _stack([(1 - x) * (1 - y), x * (1 - y), x * y, (1 - x) * y], -1)
    if et == "tet":
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        return _stack([1 - x - y - z, x, y, z], -1)
    if et == "hex":
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        return _stack(
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
            -1,
        )
    raise ValueError(et)


def geom_dshapes(et: str, pts):
    """d(N)/d(ref) (..., nv, d) at reference points pts (..., d) (tensors)."""
    if et in SIMPLICES:
        d = ET_DIM[et]
        # rows: vertex 0 -> -1 in every direction, vertex k -> e_{k-1}
        g = torch.cat([-torch.ones(1, d, dtype=pts.dtype, device=pts.device),
                       torch.eye(d, dtype=pts.dtype, device=pts.device)])
        return g.expand(pts.shape[:-1] + (d + 1, d))
    st = lambda a: torch.stack(a, -1)
    if et == "quad":
        x, y = pts[..., 0], pts[..., 1]
        return torch.stack(
            [
                st([-(1 - y), -(1 - x)]),
                st([(1 - y), -x]),
                st([y, x]),
                st([-y, (1 - x)]),
            ],
            dim=-2,
        )
    if et == "hex":
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        return torch.stack(
            [
                st([-(1 - y) * (1 - z), -(1 - x) * (1 - z), -(1 - x) * (1 - y)]),
                st([(1 - y) * (1 - z), -x * (1 - z), -x * (1 - y)]),
                st([y * (1 - z), x * (1 - z), -x * y]),
                st([-y * (1 - z), (1 - x) * (1 - z), -(1 - x) * y]),
                st([-(1 - y) * z, -(1 - x) * z, (1 - x) * (1 - y)]),
                st([(1 - y) * z, -x * z, x * (1 - y)]),
                st([y * z, x * z, x * y]),
                st([-y * z, (1 - x) * z, (1 - x) * y]),
            ],
            dim=-2,
        )
    raise ValueError(et)


# elements of one chunk of a CPU power (ATen's thread grain), and the
# multiple its flat length is padded to (a whole number of vector steps)
_POW_CHUNK = 32768
_POW_ALIGN = 64


def pointwise_pow(a, e):
    """``a ** e`` with every element's bits independent of its place in the
    tensor.  On the CPU, ATen computes the last (length mod 16) elements of
    a vectorized loop, and each thread's share of a long one, with the
    scalar libm ``pow``, whose last bit can differ from the vector path's;
    so the flat tensor is padded to whole vector steps and taken in chunks
    that one thread runs.  A rank's rows of a sharded assembly then equal
    the single-rank rows bit for bit.  On the card every element takes one
    path already."""
    if a.is_cuda:
        return a ** e
    flat = a.reshape(-1)
    n = flat.numel()
    pad = (-n) % _POW_ALIGN
    if pad:
        flat = torch.cat([flat, flat.new_ones(pad)])
    out = torch.cat([c ** e for c in flat.split(_POW_CHUNK)])
    return out[:n].reshape(a.shape)


def small_matmul(a, b):
    """a @ b with broadcasting batch dims.  On the card, as k elementwise
    multiply-adds in order: there a batched matmul of millions of tiny
    matrices runs as a library GEMM/GEMV that is many times slower than
    these memory-bound elementwise kernels.  On the CPU the batched BLAS
    product is the fast one (the loop makes k passes over the whole
    output), so the CPU takes ``torch.matmul``; the two differ in rounding
    only."""
    if not a.is_cuda:
        return torch.matmul(a, b)
    out = a[..., :, 0, None] * b[..., 0, None, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k, None] * b[..., k, None, :]
    return out


def _det(J):
    d = J.shape[-1]
    if d == 1:
        return J[..., 0, 0]
    if d == 2:
        return J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    if d == 3:
        return (
            J[..., 0, 0] * (J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1])
            - J[..., 0, 1] * (J[..., 1, 0] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 0])
            + J[..., 0, 2] * (J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0])
        )
    raise ValueError(d)


def _inv(J, detJ):
    d = J.shape[-1]
    if d == 1:
        return 1.0 / J
    st = lambda a: torch.stack(a, -1)
    if d == 2:
        a, b, c, dd = J[..., 0, 0], J[..., 0, 1], J[..., 1, 0], J[..., 1, 1]
        inv = torch.stack([st([dd, -b]), st([-c, a])], dim=-2)
        return inv / detJ[..., None, None]
    if d == 3:
        # adjugate / det
        m = J
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c02 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c10 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c20 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        c21 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        adj = torch.stack([st([c00, c01, c02]), st([c10, c11, c12]),
                           st([c20, c21, c22])], dim=-2)
        return adj / detJ[..., None, None]
    raise ValueError(d)


def det_and_inv(J):
    detJ = _det(J)
    return detJ, _inv(J, detJ)


def multilinear_grad(et: str, v, pts):
    """Gradient (B, Q, d) of the bilinear (QUAD) / trilinear (HEX)
    interpolant of corner values v (B, nv) at reference points pts
    (B|1, Q, d), from its monomial coefficients
    (straightcutrule.cpp:503-526 GetCoeffsFromVals)."""
    if et == "quad":
        v0, v1, v2, v3 = (v[:, i, None] for i in range(4))
        c10, c01, c11 = v1 - v0, v3 - v0, v2 - v1 - v3 + v0
        x, y = pts[..., 0], pts[..., 1]
        return torch.stack([c10 + c11 * y, c01 + c11 * x], dim=-1)
    v0, v1, v2, v3, v4, v5, v6, v7 = (v[:, i, None] for i in range(8))
    c100, c010, c001 = v1 - v0, v3 - v0, v4 - v0
    c110 = v2 - v1 - v3 + v0
    c101 = v5 - v1 - v4 + v0
    c011 = v7 - v3 - v4 + v0
    c111 = v6 - v2 - v5 - v7 + v1 + v3 + v4 - v0
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    return torch.stack([c100 + c110 * y + c101 * z + c111 * y * z,
                        c010 + c110 * x + c011 * z + c111 * x * z,
                        c001 + c101 * x + c011 * y + c111 * x * y], dim=-1)


def map_jacobian(et: str, elem_coords, ref_pts):
    """J (E, Q, g, d) of the geometry map at ref_pts (E|1, Q, d); on
    simplices, whose map is affine, once per element: (E, 1, g, d),
    broadcasting against the point axis (the reference materializes it per
    point).  QUAD/HEX rows come from ``multilinear_grad``, without an
    (E, Q, nv, d) table of shape gradients."""
    if et in SIMPLICES:
        dN = geom_dshapes(et, ref_pts[..., :1, :])  # (E|1, 1, nv, d)
        return small_matmul(elem_coords.transpose(-1, -2)[:, None], dN)
    return torch.stack([multilinear_grad(et, elem_coords[:, :, g], ref_pts)
                        for g in range(elem_coords.shape[-1])], dim=-2)


def map_points(et: str, elem_coords, ref_pts):
    """Map reference points to physical space.

    elem_coords (E, nv, g) element vertex coordinates, ref_pts (E, Q, d), or
    (1, Q, d) for one point set shared by all elements ->
    (phys (E, Q, g), J as ``map_jacobian`` gives it).
    """
    phys = small_matmul(geom_shapes(et, ref_pts), elem_coords)  # (E, Q, g)
    return phys, map_jacobian(et, elem_coords, ref_pts)
