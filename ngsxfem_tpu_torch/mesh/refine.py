"""Adaptive mesh refinement (2D triangles, 3D tets) and uniform quad/hex
refinement.

Counterpart of ``ngsxfem_tpu/mesh/refine.py`` (host numpy, the same
algorithms, so the same meshes bit for bit).  The reference's netgen-backed
local refinement (``lsetcurving/lsetrefine.cpp:13-42`` RefineAtLevelSet sets
per-element refinement flags; netgen executes them) is an explicit host-side
mesh transformation here.

Triangles: longest-edge red/green/blue subdivision with a conformity
closure (no hanging nodes), the standard Rivara-style scheme: 1 split
edge -> bisection (2 children), 2 -> blue (3), 3 -> red (4).

Tets: recursive longest-edge (Rivara) bisection: marked tets have all six
edges queued for splitting; every element containing a queued edge bisects
at its own longest edge (queueing it if needed, which propagates the
closure to neighbors) until no element contains a queued edge.  The result
is conforming (every queued edge is bisected in every element containing
it, so midpoints are never hanging).

``refine_mesh`` ends by dropping the mesh's device views and cached
geometry, unsetting its deformation and bumping its ``_version``, so that
nothing made from the old mesh is served for the refined one.
"""
from __future__ import annotations

import numpy as np


def _edge_key(u, v):
    return (u, v) if u < v else (v, u)


def bisect_refine_trig(vertices: np.ndarray, elements: np.ndarray,
                       marks: np.ndarray,
                       bc_edges: dict | None = None):
    """Refine marked triangles; returns (vertices, elements, bc_edges), as
    the JAX package does (``_bisect_trig`` adds the parent index)."""
    return _bisect_trig(vertices, elements, marks, bc_edges)[:3]


def bisect_refine_tet(vertices: np.ndarray, elements: np.ndarray,
                      marks: np.ndarray, bc_faces: dict | None = None):
    """Rivara bisection of marked tets; returns (vertices, elements, info),
    as the JAX package does (``_bisect_tet`` adds the parent index)."""
    return _bisect_tet(vertices, elements, marks, bc_faces)[:3]


def _bisect_trig(vertices: np.ndarray, elements: np.ndarray,
                 marks: np.ndarray, bc_edges: dict | None = None):
    """Refine marked triangles; returns (vertices, elements, bc_edges,
    parent), parent[i] the coarse element child i came from.

    vertices (nv, 2) float64, elements (ne, 3) int, marks (ne,) bool.
    bc_edges: {sorted-edge-tuple: bc_id} for boundary edges; child boundary
    edges inherit the parent's bc id.
    """
    nv = len(vertices)
    ne = len(elements)
    els = np.asarray(elements, dtype=np.int64)
    V = np.asarray(vertices, dtype=np.float64)

    # local edges: e0=(0,1), e1=(1,2), e2=(0,2)
    eloc = np.array([[0, 1], [1, 2], [0, 2]])
    epairs = els[:, eloc]  # (ne, 3, 2)
    elen = np.linalg.norm(V[epairs[..., 0]] - V[epairs[..., 1]], axis=-1)
    longest = np.argmax(elen, axis=1)  # (ne,)

    ekeys = np.sort(epairs, axis=-1)  # (ne, 3, 2)

    # marked elements refine red (all edges split); the closure below adds
    # green/blue transitions in their neighbors
    split = set()
    for e in np.nonzero(np.asarray(marks, dtype=bool))[0]:
        for j in range(3):
            k = ekeys[e, j]
            split.add((int(k[0]), int(k[1])))
    # conformity closure: any element with a split edge must split its
    # longest edge too
    changed = True
    while changed:
        changed = False
        for e in range(ne):
            keys = [tuple(ekeys[e, j]) for j in range(3)]
            if any(k in split for k in keys):
                kl = keys[longest[e]]
                if kl not in split:
                    split.add(kl)
                    changed = True

    if not split:
        return V, els.astype(np.int32), dict(bc_edges or {}), np.arange(ne)

    # midpoints
    mid_of = {}
    new_pts = []
    for k in sorted(split):
        mid_of[k] = nv + len(new_pts)
        new_pts.append(0.5 * (V[k[0]] + V[k[1]]))
    Vnew = np.concatenate([V, np.asarray(new_pts).reshape(-1, 2)], axis=0)

    # child elements
    out = []
    parent = []
    rot = {0: (0, 1, 2), 1: (1, 2, 0), 2: (2, 0, 1)}
    for e in range(ne):
        n0 = len(out)
        keys = [tuple(ekeys[e, j]) for j in range(3)]
        s = [k in split for k in keys]
        if not any(s):
            out.append(tuple(els[e]))
            parent.append(e)
            continue
        # rotate so the longest (split, by closure) edge is (a, b)
        ra, rb, rc = rot[longest[e]]
        a, b, c = int(els[e, ra]), int(els[e, rb]), int(els[e, rc])
        k_ab = _edge_key(a, b)
        k_bc = _edge_key(b, c)
        k_ac = _edge_key(a, c)
        m_ab = mid_of[k_ab]
        s_bc = k_bc in split
        s_ac = k_ac in split
        if s_bc and s_ac:  # red
            m_bc, m_ac = mid_of[k_bc], mid_of[k_ac]
            out += [(a, m_ab, m_ac), (m_ab, b, m_bc), (m_ac, m_bc, c),
                    (m_ab, m_bc, m_ac)]
        elif s_bc:  # blue
            m_bc = mid_of[k_bc]
            out += [(a, m_ab, c), (m_ab, b, m_bc), (m_ab, m_bc, c)]
        elif s_ac:  # blue
            m_ac = mid_of[k_ac]
            out += [(m_ab, b, c), (a, m_ab, m_ac), (m_ab, c, m_ac)]
        else:  # green bisection
            out += [(a, m_ab, c), (m_ab, b, c)]
        parent += [e] * (len(out) - n0)
    Enew = np.asarray(out, dtype=np.int32)

    # propagate boundary bc ids to child edges
    bc_new = {}
    if bc_edges:
        for (u, v), bc in bc_edges.items():
            k = _edge_key(u, v)
            if k in mid_of:
                m = mid_of[k]
                bc_new[_edge_key(u, m)] = bc
                bc_new[_edge_key(m, v)] = bc
            else:
                bc_new[k] = bc
    return Vnew, Enew, bc_new, np.asarray(parent)


def _bisect_tet(vertices: np.ndarray, elements: np.ndarray,
                marks: np.ndarray, bc_faces: dict | None = None):
    """Rivara longest-edge bisection of marked tets with conformity closure.

    vertices (nv, 3) float64, elements (ne, 4) int, marks (ne,) bool.
    bc_faces: {sorted-3-tuple: bc_id} for boundary faces; returns
    (vertices, elements, info, parent): info the boundary faces and their
    vertex-on-face ancestry (the midpoint of an edge whose endpoints lie on
    a face lies on that face), from which child faces inherit the parent's
    id, or None if nothing split; parent[i] the coarse element of child i.
    """
    V = [v for v in np.asarray(vertices, dtype=np.float64)]
    els = [tuple(int(v) for v in e) for e in np.asarray(elements)]
    bc_faces = dict(bc_faces or {})

    # vertex -> set of original boundary faces it lies on
    face_list = list(bc_faces.items())  # [(tri, bc)]
    vfaces = {}
    for fi, (tri, _bc) in enumerate(face_list):
        for v in tri:
            vfaces.setdefault(int(v), set()).add(fi)

    mid_of = {}

    def edge_len2(e):
        d = V[e[0]] - V[e[1]]
        return float(d @ d)

    def midpoint(e):
        m = mid_of.get(e)
        if m is None:
            m = len(V)
            V.append(0.5 * (V[e[0]] + V[e[1]]))
            fa = vfaces.get(e[0], set()) & vfaces.get(e[1], set())
            if fa:
                vfaces[m] = fa
            mid_of[e] = m
        return m

    split = set()
    for e in np.nonzero(np.asarray(marks, dtype=bool))[0]:
        t = els[e]
        for i in range(4):
            for j in range(i + 1, 4):
                split.add(_edge_key(t[i], t[j]))
    if not split:
        return (np.asarray(V), np.asarray(els, dtype=np.int32), None,
                np.arange(len(els)))

    def split_edges(t):
        return [_edge_key(t[i], t[j])
                for i in range(4) for j in range(i + 1, 4)]

    work = [(t, p) for p, t in enumerate(els)]   # (child, coarse parent)
    out = []
    for _pass in range(256):  # Rivara terminates; cap defensively
        new_work = []
        for t, p in work:
            edges6 = split_edges(t)
            if not any(e in split for e in edges6):
                out.append((t, p))
                continue
            # bisect at the LONGEST edge (queue it if not queued yet — this
            # is the closure propagation to neighbors sharing it)
            le = max(edges6, key=edge_len2)
            split.add(le)
            m = midpoint(le)
            a, b = le
            c1 = tuple(m if v == b else v for v in t)
            c2 = tuple(m if v == a else v for v in t)
            new_work += [(c1, p), (c2, p)]
        # `split` grew while this pass ran: elements finalized earlier (this
        # pass or before) may now contain split edges — pull them back in,
        # else their neighbors' midpoints become hanging nodes
        still_out = []
        for t, p in out:
            if any(e in split for e in split_edges(t)):
                new_work.append((t, p))
            else:
                still_out.append((t, p))
        out = still_out
        work = new_work
        if not work:
            break
    else:
        raise RuntimeError("tet bisection did not terminate (256 passes)")

    Vnew = np.asarray(V)
    Enew = np.asarray([t for t, _ in out], dtype=np.int32)
    # fix inverted children (vertex substitution can flip orientation)
    from .io import _fix_orientation

    _fix_orientation("tet", Vnew, Enew)

    return Vnew, Enew, (face_list, vfaces), np.asarray([p for _, p in out])


def _tet_bc_assign(mesh, face_list, vfaces):
    """Per-facet bc ids of the refined mesh from vertex-on-face ancestry."""
    bc = np.zeros(mesh.nfacets, dtype=np.int32)
    for fi in mesh.boundary_facets_np:
        tri = mesh.facets_np[fi]
        common = None
        for v in tri:
            s = vfaces.get(int(v))
            if s is None:
                common = set()
                break
            common = s if common is None else (common & s)
        if common:
            bc[fi] = face_list[min(common)][1]
        else:
            bc[fi] = 1
    return bc


def uniform_refine_tensor(vertices: np.ndarray, elements: np.ndarray,
                          et: str):
    """Uniform 1->4 (quad) / 1->8 (hex) refinement of a tensor-product mesh.

    The netgen-analog of ``mesh.Refine()`` on quad/hex meshes (the reference
    relies on netgen's uniform refinement there; adaptive tensor refinement
    would create hanging nodes and is not offered — matching netgen).

    New vertices are identified **topologically** (key = sorted tuple of the
    parent vertex ids they average: edge pair, face quad, or cell), so shared
    midpoints between neighboring elements dedup exactly regardless of
    floating-point summation order.  For the (multi)linear geometry map the
    averaged coordinates coincide with the map evaluated at the dyadic
    lattice, so the refined mesh is geometrically conforming.

    Returns (vertices, elements, vkey): `vkey[new_vid] = sorted parent-id
    tuple` for every newly created vertex (used for bc inheritance).  The
    children of each element follow one another, in element order.
    """
    V = np.asarray(vertices, dtype=np.float64)
    E = np.asarray(elements, dtype=np.int64)
    d = 2 if et == "quad" else 3
    # REF_VERTS-consistent corner ordering as (x,y[,z]) offsets
    if et == "quad":
        corner_off = [(0, 0), (1, 0), (1, 1), (0, 1)]
    else:
        corner_off = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                      (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]

    verts = [v for v in V]
    key2id: dict[tuple, int] = {}
    vkey: dict[int, tuple] = {}

    def lattice_vid(el, pt):
        """Vertex id of lattice point pt in {0,1,2}^d of element el."""
        support = []
        for ci, off in enumerate(corner_off):
            ok = all(
                (p == 1) or (p == 0 and o == 0) or (p == 2 and o == 1)
                for p, o in zip(pt, off)
            )
            if ok:
                support.append(int(E[el, ci]))
        if len(support) == 1:
            return support[0]
        key = tuple(sorted(support))
        vid = key2id.get(key)
        if vid is None:
            vid = len(verts)
            key2id[key] = vid
            verts.append(V[np.array(key)].mean(axis=0))
            vkey[vid] = key
        return vid

    children = []
    cells = ([(i, j) for j in (0, 1) for i in (0, 1)] if d == 2 else
             [(i, j, k) for k in (0, 1) for j in (0, 1) for i in (0, 1)])
    for el in range(E.shape[0]):
        for cell in cells:
            child = [
                lattice_vid(el, tuple(c + o for c, o in zip(cell, off)))
                for off in corner_off
            ]
            children.append(child)
    return (np.asarray(verts, dtype=np.float64),
            np.asarray(children, dtype=np.int64), vkey)


def _tensor_bc_assign(mesh, vkey, bc_facets):
    """Inherit bc ids onto child boundary facets of a refined quad/hex mesh.

    A child boundary facet consists of parent-level vertices and averaged
    vertices; replacing each averaged vertex by its parent-id key and taking
    the union reproduces the parent facet's vertex set exactly."""
    bc = np.zeros(mesh.nfacets, dtype=np.int32)
    for fi in mesh.boundary_facets_np:
        parents = set()
        for v in mesh.facets_np[fi]:
            v = int(v)
            parents.update(vkey.get(v, (v,)))
        bc[fi] = bc_facets.get(tuple(sorted(parents)), 1)
    return bc


def refine_mesh(mesh, marks=None):
    """In-place refinement of a Mesh; marks=None refines uniformly.

    FE spaces and GridFunctions built on the old mesh are not transferred:
    rebuild them (the reference tutorials also reconstruct spaces after
    mesh.Refine()).
    """
    if mesh.et not in ("trig", "tet", "quad", "hex"):
        raise NotImplementedError(
            f"refinement for element type {mesh.et!r}"
        )
    if (mesh.periodic_facet_np >= 0).any():
        raise NotImplementedError(
            "refinement of periodic meshes is not supported (the periodic "
            "facet identification would need to be rebuilt)")
    if marks is None:
        marks = np.ones(mesh.ne, dtype=bool)
    else:
        marks = np.asarray(marks.np if hasattr(marks, "np") else marks,
                           dtype=bool)

    ne0 = mesh.ne
    if mesh.et in ("quad", "hex"):
        if not marks.all():
            raise NotImplementedError(
                "adaptive refinement of quad/hex meshes would create "
                "hanging nodes (netgen has the same restriction); call "
                "Refine() without marks for uniform refinement or use a "
                "simplicial mesh"
            )
        bc_facets = {
            tuple(sorted(int(v) for v in mesh.facets_np[fi])):
            int(mesh.bc_of_facet_np[fi])
            for fi in mesh.boundary_facets_np
        }
        Vn, En, vkey = uniform_refine_tensor(
            mesh.vertices_np, mesh.elements_np, mesh.et)
        mesh.vertices_np = np.asarray(Vn, dtype=np.float64)
        mesh.elements_np = np.asarray(En, dtype=np.int32)
        mesh.nv = len(Vn)
        mesh.ne = len(En)
        mesh._build_facets()
        mesh.bc_of_facet_np = _tensor_bc_assign(mesh, vkey, bc_facets)
        parent = np.repeat(np.arange(ne0), len(En) // ne0)
    elif mesh.et == "trig":
        # current boundary bc map
        bc_edges = {}
        for fi in mesh.boundary_facets_np:
            u, v = mesh.facets_np[fi]
            bc_edges[_edge_key(int(u), int(v))] = int(mesh.bc_of_facet_np[fi])

        Vn, En, bc_new, parent = _bisect_trig(
            mesh.vertices_np, mesh.elements_np, marks, bc_edges)

        mesh.vertices_np = np.asarray(Vn, dtype=np.float64)
        mesh.elements_np = np.asarray(En, dtype=np.int32)
        mesh.nv = len(Vn)
        mesh.ne = len(En)
        mesh._build_facets()
        bc = np.zeros(mesh.nfacets, dtype=np.int32)
        for fi in mesh.boundary_facets_np:
            u, v = mesh.facets_np[fi]
            bc[fi] = bc_new.get(_edge_key(int(u), int(v)), 1)
        mesh.bc_of_facet_np = bc
    else:
        bc_faces = {
            tuple(sorted(int(v) for v in mesh.facets_np[fi])):
            int(mesh.bc_of_facet_np[fi])
            for fi in mesh.boundary_facets_np
        }
        Vn, En, info, parent = _bisect_tet(
            mesh.vertices_np, mesh.elements_np, marks, bc_faces)
        mesh.vertices_np = np.asarray(Vn, dtype=np.float64)
        mesh.elements_np = np.asarray(En, dtype=np.int32)
        mesh.nv = len(Vn)
        mesh.ne = len(En)
        old_bc = mesh.bc_of_facet_np
        mesh._build_facets()
        if info is None:  # nothing split
            mesh.bc_of_facet_np = old_bc
        else:
            face_list, vfaces = info
            mesh.bc_of_facet_np = _tet_bc_assign(mesh, face_list, vfaces)
    mesh.mat_of_el_np = mesh.mat_of_el_np[parent]   # children keep theirs
    # facet count changed: reset the (empty) periodic identification
    mesh.periodic_facet_np = np.full(mesh.nfacets, -1, dtype=np.int64)
    mesh._drop_caches()
    mesh.deformation = None
    mesh._version += 1
    mesh._refine_marks = None
    return mesh
