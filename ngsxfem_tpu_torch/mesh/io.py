"""Unstructured mesh ingestion: array import, Gmsh I/O, Delaunay meshers.

Counterpart of ``ngsxfem_tpu/mesh/io.py`` (host numpy and scipy, the same
construction, so the same meshes bit for bit).  The reference runs its
tutorials on arbitrary Netgen meshes (``py_tutorials/nxfem.py:24-27``
SplineGeometry, CSG in ``tracefem3d.py``).  The port's ``Mesh`` holds one
element type; the ingestion paths here produce it from (a) raw arrays, (b)
Gmsh v2.2 ASCII files, (c) scipy Delaunay triangulations of arbitrary point
sets: the "bring your own mesh" workflow without a Netgen dependency.
Material ids travel in ``mat_of_el_np`` (``Mesh.Materials``,
``Integrate(region_wise=True)``).
"""
from __future__ import annotations

import numpy as np

from .mesh import Mesh, FACET_VERTS
from ..ops.gauss import ET_DIM, ET_NVERT

_ET_BY_DIM_NV = {(1, 2): "segm", (2, 3): "trig", (2, 4): "quad",
                 (3, 4): "tet", (3, 8): "hex"}


def _fix_orientation(et: str, vertices: np.ndarray, elements: np.ndarray):
    """Reorder inverted simplices (negative signed volume) in place; returns
    the number fixed.  Quad/hex are left untouched (multilinear maps may be
    legitimately non-affine; the library uses |detJ| throughout)."""
    if et not in ("trig", "tet", "segm"):
        return 0
    d = ET_DIM[et]
    v = vertices[elements]  # (ne, d+1, d)
    E = v[:, 1:d + 1] - v[:, :1]
    det = np.linalg.det(E) if d > 1 else E[:, 0, 0]
    bad = det < 0
    if bad.any():
        elements[bad, -1], elements[bad, -2] = (
            elements[bad, -2].copy(), elements[bad, -1].copy())
    return int(bad.sum())


def MeshFromArrays(et: str, vertices, elements, bc_of_facet=None,
                   bc_names=None, fix_orientation=True, mat_of_el=None,
                   mat_names=None):
    """Build a Mesh from raw arrays (the "bring your own mesh" entry).

    vertices (nv, d) float, elements (ne, nvel) int (single element type
    ``et`` in {"segm","trig","quad","tet","hex"}); ``bc_of_facet`` may be
    a per-facet id array (built after facet enumeration) or a dict
    {sorted-vertex-tuple: bc_id} for boundary facets.  ``mat_of_el``
    ((ne,) 1-based material ids) and ``mat_names`` ({id: name}) define
    material regions (``Integrate(region_wise=True)``).
    """
    vertices = np.asarray(vertices, dtype=np.float64)
    elements = np.asarray(elements, dtype=np.int32).copy()
    if elements.shape[1] != ET_NVERT[et]:
        raise ValueError(
            f"{et} elements need {ET_NVERT[et]} vertices, got "
            f"{elements.shape[1]}")
    if fix_orientation:
        _fix_orientation(et, vertices, elements)
    bc_arr = bc_of_facet if not isinstance(bc_of_facet, dict) else None
    m = Mesh(et, vertices, elements, bc_of_facet=bc_arr, bc_names=bc_names,
             mat_of_el=mat_of_el, mat_names=mat_names)
    if isinstance(bc_of_facet, dict):
        bc = np.zeros(m.nfacets, dtype=np.int32)
        keys = {tuple(sorted(int(x) for x in k)): int(v)
                for k, v in bc_of_facet.items()}
        for fi in m.boundary_facets_np:
            key = tuple(sorted(int(x) for x in m.facets_np[fi]))
            bc[fi] = keys.get(key, 1)
        m.bc_of_facet_np = bc
    return m


# -- Gmsh v2.2 ASCII ---------------------------------------------------------

# gmsh element type id -> (et, nv); facet types carry boundary ids
_GMSH_TYPES = {1: ("segm", 2), 2: ("trig", 3), 3: ("quad", 4),
               4: ("tet", 4), 5: ("hex", 8), 15: ("point", 1)}
_GMSH_ID = {"segm": 1, "trig": 2, "quad": 3, "tet": 4, "hex": 5}


def ReadGmsh(path):
    """Read a Gmsh v2.2 ASCII ``.msh`` file into a Mesh.

    Highest-dimension cells become the element set; their facet-dimension
    elements provide boundary ids from the physical tag; ``$PhysicalNames``
    populates ``mesh.bc_names``.  A file mixing several cell types of the
    same dimension (e.g. quad-dominated trig+quad) returns a
    ``CompositeMesh`` of single-type groups (boundary tags are dropped —
    CompositeMesh carries none; a warning says so).
    """
    with open(path) as f:
        lines = f.read().split("\n")
    i = 0
    nodes = {}
    elems = []
    phys_names = {}
    while i < len(lines):
        line = lines[i].strip()
        if line == "$MeshFormat":
            ver = lines[i + 1].split()[0]
            if not ver.startswith("2"):
                raise NotImplementedError(
                    f"Gmsh format {ver}: only v2.x ASCII is supported "
                    "(export with gmsh -format msh2)")
            i += 3
        elif line == "$PhysicalNames":
            n = int(lines[i + 1])
            for j in range(n):
                parts = lines[i + 2 + j].split(None, 2)
                # gmsh physical tags are namespaced PER DIMENSION
                phys_names[(int(parts[0]), int(parts[1]))] = \
                    parts[2].strip().strip('"')
            i += n + 3
        elif line == "$Nodes":
            n = int(lines[i + 1])
            for j in range(n):
                parts = lines[i + 2 + j].split()
                nodes[int(parts[0])] = [float(x) for x in parts[1:4]]
            i += n + 3
        elif line == "$Elements":
            n = int(lines[i + 1])
            for j in range(n):
                parts = [int(x) for x in lines[i + 2 + j].split()]
                etype, ntags = parts[1], parts[2]
                tags = parts[3:3 + ntags]
                verts = parts[3 + ntags:]
                if etype in _GMSH_TYPES:
                    et, nv = _GMSH_TYPES[etype]
                    elems.append((et, tags[0] if tags else 0, verts))
            i += n + 3
        else:
            i += 1

    if not nodes or not elems:
        raise ValueError("no nodes/elements found (is this a v2.2 .msh?)")
    by_et = {}
    for et, tag, verts in elems:
        by_et.setdefault(et, []).append((tag, verts))
    cell_et = max(by_et, key=lambda e: ET_DIM.get(e, 0))
    dim = ET_DIM[cell_et]
    cell_ets = sorted(e for e in by_et if ET_DIM.get(e, 0) == dim)

    # renumber contiguously, keeping ONLY nodes referenced by a top-dimension
    # cell: orphan nodes (physical points, lower-dim-only nodes) would leave
    # all-zero matrix rows / singular H1 systems behind
    used = set()
    for e in cell_ets:
        for _, verts in by_et[e]:
            used.update(verts)
    ids = sorted(g for g in nodes if g in used)
    id2new = {g: k for k, g in enumerate(ids)}
    pts3 = np.array([nodes[g] for g in ids], dtype=np.float64)
    vertices = pts3[:, :dim]
    if len(cell_ets) > 1:
        # mixed same-dimension cell types: a single-type Mesh would have to
        # DROP cells — return the composite representation instead
        import warnings

        from .composite import CompositeMesh

        has_bc = any(ET_DIM.get(e, -1) == dim - 1 for e in by_et)
        warnings.warn(
            f"ReadGmsh: mixed cell types {cell_ets} -> CompositeMesh"
            + ("; boundary tags dropped" if has_bc else ""))
        groups = [(e, np.array([[id2new[v] for v in verts]
                                for _, verts in by_et[e]], dtype=np.int32))
                  for e in cell_ets]
        return CompositeMesh(vertices, groups)
    elements = np.array(
        [[id2new[v] for v in verts] for _, verts in by_et[cell_et]],
        dtype=np.int32)
    # material ids from the cells' physical tags (gmsh physical VOLUMES /
    # surfaces in 2D; reference analog: NGSolve materials consumed by
    # Integrate(region_wise=True), python/__init__.py:358)
    cell_tags = np.array([tag for tag, _ in by_et[cell_et]], dtype=np.int32)
    mat_of_el = np.where(cell_tags > 0, cell_tags, 1)
    mat_names = {int(t): phys_names[(dim, int(t))]
                 for t in np.unique(mat_of_el)
                 if (dim, int(t)) in phys_names}

    # boundary ids from facet-dimension elements (keyed by vertex tuple)
    bc_map = {}
    for et, items in by_et.items():
        if et == cell_et or ET_DIM.get(et, -1) != dim - 1:
            continue
        for tag, verts in items:
            if not all(v in id2new for v in verts):
                continue  # facet of dropped (orphan-node) geometry
            key = tuple(sorted(id2new[v] for v in verts))
            bc_map[key] = tag if tag > 0 else 1
    bc_names = {int(t): nm for (d_, t), nm in phys_names.items()
                if d_ == dim - 1}
    return MeshFromArrays(cell_et, vertices, elements,
                          bc_of_facet=bc_map or None,
                          bc_names=bc_names or None,
                          mat_of_el=mat_of_el, mat_names=mat_names or None)


def WriteGmsh(mesh: Mesh, path):
    """Write a Mesh as Gmsh v2.2 ASCII (cells + tagged boundary facets)."""
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{mesh.nv}\n")
        for i, v in enumerate(mesh.vertices_np):
            xyz = list(v) + [0.0] * (3 - len(v))
            f.write(f"{i + 1} {xyz[0]} {xyz[1]} {xyz[2]}\n")
        f.write("$EndNodes\n")
        bf = mesh.boundary_facets_np
        f.write(f"$Elements\n{mesh.ne + len(bf)}\n")
        eid = 1
        from .mesh import FACET_ET

        fid = _GMSH_ID[FACET_ET[mesh.et]]
        for fi in bf:
            tag = int(mesh.bc_of_facet_np[fi])
            vs = " ".join(str(int(v) + 1) for v in mesh.facets_np[fi])
            f.write(f"{eid} {fid} 2 {tag} {tag} {vs}\n")
            eid += 1
        cid = _GMSH_ID[mesh.et]
        for el, mt in zip(mesh.elements_np, mesh.mat_of_el_np):
            vs = " ".join(str(int(v) + 1) for v in el)
            f.write(f"{eid} {cid} 2 {int(mt)} {int(mt)} {vs}\n")
            eid += 1
        f.write("$EndElements\n")


# -- genuinely unstructured simplicial meshes --------------------------------

def MakeUnstructuredMesh(dim=2, npts=120, seed=0, mapping=None):
    """Delaunay mesh of the unit square/cube: random interior points plus a
    boundary point ring, scipy.spatial.Delaunay connectivity — a genuinely
    unstructured simplicial mesh (no structured axes anywhere).

    ``mapping`` optionally post-maps the unit box (same convention as the
    structured generators).  Boundary ids follow the structured numbering.
    """
    from scipy.spatial import Delaunay
    from .structured import _facet_bc_from_unitbox, _BC_NAMES_2D, _BC_NAMES_3D

    rng = np.random.default_rng(seed)
    nb = max(4, int(round(npts ** (1.0 / dim))))
    side = np.linspace(0.0, 1.0, nb + 1)
    if dim == 2:
        bpts = [np.stack([side, np.zeros_like(side)], 1),
                np.stack([side, np.ones_like(side)], 1),
                np.stack([np.zeros_like(side[1:-1]), side[1:-1]], 1),
                np.stack([np.ones_like(side[1:-1]), side[1:-1]], 1)]
    else:
        G1, G2 = np.meshgrid(side, side, indexing="ij")
        face = np.stack([G1.ravel(), G2.ravel()], 1)
        bpts = []
        for ax in range(3):
            for val in (0.0, 1.0):
                p = np.insert(face, ax, val, axis=1)
                bpts.append(p)
    bpts = np.unique(np.concatenate(bpts, 0), axis=0)
    interior = rng.uniform(0.08, 0.92, size=(npts, dim))
    pts = np.concatenate([bpts, interior], 0)
    tri = Delaunay(pts)
    elements = tri.simplices.astype(np.int32)
    # drop degenerate slivers (zero volume to machine precision)
    v = pts[elements]
    E = v[:, 1:] - v[:, :1]
    det = np.linalg.det(E)
    elements = elements[np.abs(det) > 1e-12 / (nb ** dim)]
    unit = pts.copy()
    verts = pts
    if mapping is not None:
        verts = np.array([mapping(*p) for p in pts], dtype=np.float64)
    m = MeshFromArrays("trig" if dim == 2 else "tet", verts, elements)
    m.bc_of_facet_np = _facet_bc_from_unitbox(m, unit, dim)
    m.bc_names = _BC_NAMES_2D if dim == 2 else _BC_NAMES_3D
    return m
