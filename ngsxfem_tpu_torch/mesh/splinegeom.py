"""2D spline-boundary geometry + unstructured triangle mesher.

Counterpart of ``ngsxfem_tpu/mesh/splinegeom.py`` (host numpy and scipy,
the same construction, so the same meshes bit for bit).  API parity with
the ``netgen.geom2d.SplineGeometry`` subset the reference tutorials drive
(``py_tutorials/cutfem.py:83-85``, ``nxfem.py:24-27``,
``moving_domain.py:160-163``): ``AddPoint`` / ``Append(["line"|"spline3",
...], bc=..., leftdomain=..., rightdomain=...)`` / ``AddRectangle`` /
``AddCircle`` / ``SetMaterial`` / ``GenerateMesh(maxh=...)``.

The mesher itself is ours, and host-side by design — mesh generation is a
one-time setup cost, so it runs in numpy on the host and hands the device a
static SoA ``Mesh``:

1. every boundary segment is sampled arc-length-uniformly at spacing
   <= maxh (``spline3`` segments are rational quadratic Beziers with the
   circle-exact weight ``sin(beta/2)``, beta the control-point angle, so
   ``AddCircle`` samples lie ON the circle to machine precision);
2. each material domain is seeded with a hexagonal interior lattice at
   spacing maxh, clipped by the domain's winding number and a 0.55*maxh
   standoff from the boundary polylines;
3. scipy Delaunay over boundary + interior nodes, triangles classified by
   centroid winding number per domain (mat ids; outside-everything = drop);
4. missing boundary edges (rare at these densities) are recovered by
   midpoint insertion + re-triangulation, and two relaxed Laplacian
   smoothing passes on the interior nodes round off the lattice bias.

Multiple domains (leftdomain/rightdomain > 1) become element material
ids (``mat_of_el_np``, ``Integrate(region_wise=True)``); exterior boundary
edges carry the segment's ``bc``.
"""

from __future__ import annotations

import math

import numpy as np

from .mesh import Mesh

__all__ = ["SplineGeometry", "MakeCircle", "MakeRectangle"]


def _spline3_eval(p1, pc, p3, w, t):
    """Rational quadratic Bezier through ``p1 -> p3`` with control ``pc``
    and middle weight ``w`` (netgen SplineSeg3 analog): for a circular-arc
    configuration (pc at the tangent intersection, ``w = sin(beta/2)``) the
    curve IS the arc."""
    t = np.asarray(t, dtype=np.float64)[:, None]
    b1 = (1.0 - t) ** 2
    b2 = 2.0 * t * (1.0 - t) * w
    b3 = t ** 2
    den = b1 + b2 + b3
    return (b1 * p1 + b2 * pc + b3 * p3) / den


def _arclen_params(sample_fn, n_out, n_probe=256):
    """Parameters t_0..t_{n_out} that split the curve ``sample_fn(t)`` into
    ``n_out`` pieces of (numerically) equal arc length."""
    tp = np.linspace(0.0, 1.0, n_probe + 1)
    pts = sample_fn(tp)
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = cum[-1]
    targets = np.linspace(0.0, total, n_out + 1)
    return np.interp(targets, cum, tp), total


def _winding(query, edges_a, edges_b):
    """Vectorized winding number of ``query`` (n,2) wrt the oriented edge
    soup ``edges_a -> edges_b`` (m,2 each), via summed signed angles.  ~1
    inside a CCW loop, ~0 outside."""
    qa = edges_a[None, :, :] - query[:, None, :]   # (n, m, 2)
    qb = edges_b[None, :, :] - query[:, None, :]
    cross = qa[..., 0] * qb[..., 1] - qa[..., 1] * qb[..., 0]
    dot = (qa * qb).sum(-1)
    return np.arctan2(cross, dot).sum(1) / (2.0 * np.pi)


def _seg_dist(query, edges_a, edges_b):
    """Min distance from each query point to the edge soup (vectorized)."""
    d = edges_b - edges_a                            # (m, 2)
    l2 = np.maximum((d * d).sum(-1), 1e-300)
    qa = query[:, None, :] - edges_a[None, :, :]     # (n, m, 2)
    t = np.clip((qa * d[None]).sum(-1) / l2[None], 0.0, 1.0)
    proj = edges_a[None] + t[..., None] * d[None]
    return np.linalg.norm(query[:, None, :] - proj, axis=-1).min(1)


class SplineGeometry:
    """2D piecewise line/spline3 boundary description + triangle mesher
    (``netgen.geom2d.SplineGeometry`` analog; see module docstring)."""

    def __init__(self):
        self._points = []          # (x, y)
        self._segments = []        # dicts: kind, nodes, bc, left, right
        self._bc_ids = {}          # name -> id
        self._bc_names = {}        # id -> name
        self._materials = {}       # domain id -> name
        self._dom_maxh = {}        # domain id -> maxh

    # -- geometry assembly ---------------------------------------------------
    def AddPoint(self, x, y=None, maxh=None):
        if y is None:
            x, y = x
        self._points.append((float(x), float(y)))
        return len(self._points) - 1

    def _bc_id(self, bc):
        if bc is None:
            bc = 1
        if isinstance(bc, str):
            if bc not in self._bc_ids:
                self._bc_ids[bc] = len(self._bc_ids) + 1
                self._bc_names[self._bc_ids[bc]] = bc
            return self._bc_ids[bc]
        bc = int(bc)
        self._bc_names.setdefault(bc, f"bc{bc}")
        return bc

    def Append(self, spec, bc=None, leftdomain=1, rightdomain=0, maxh=None):
        kind = spec[0]
        if kind not in ("line", "spline3"):
            raise NotImplementedError(f"segment kind {kind!r}")
        self._segments.append(dict(
            kind=kind, nodes=tuple(int(p) for p in spec[1:]),
            bc=self._bc_id(bc), left=int(leftdomain), right=int(rightdomain),
            maxh=maxh))
        return len(self._segments) - 1

    def AddRectangle(self, p1, p2, bc=None, bcs=None, leftdomain=1,
                     rightdomain=0):
        """CCW rectangle ``p1`` (lower-left) to ``p2`` (upper-right); the
        enclosed region is ``leftdomain`` (netgen convention: the domain to
        the LEFT walking the segment)."""
        x1, y1 = p1
        x2, y2 = p2
        ids = [self.AddPoint(x, y) for x, y in
               ((x1, y1), (x2, y1), (x2, y2), (x1, y2))]
        if bcs is None:
            bcs = [bc] * 4
        for k in range(4):
            self.Append(["line", ids[k], ids[(k + 1) % 4]], bc=bcs[k],
                        leftdomain=leftdomain, rightdomain=rightdomain)
        return ids

    def AddCircle(self, c, r, bc=None, leftdomain=1, rightdomain=0,
                  maxh=None):
        """CCW circle of radius ``r`` about ``c`` as four circle-exact
        ``spline3`` quarter arcs (control points on the tangent square)."""
        cx, cy = c
        on = [(cx + r, cy), (cx, cy + r), (cx - r, cy), (cx, cy - r)]
        ctrl = [(cx + r, cy + r), (cx - r, cy + r),
                (cx - r, cy - r), (cx + r, cy - r)]
        on_ids = [self.AddPoint(x, y) for x, y in on]
        ct_ids = [self.AddPoint(x, y) for x, y in ctrl]
        for k in range(4):
            self.Append(["spline3", on_ids[k], ct_ids[k],
                         on_ids[(k + 1) % 4]], bc=bc,
                        leftdomain=leftdomain, rightdomain=rightdomain,
                        maxh=maxh)
        return on_ids

    def SetMaterial(self, domnr, name):
        self._materials[int(domnr)] = str(name)

    def SetDomainMaxH(self, domnr, maxh):
        self._dom_maxh[int(domnr)] = float(maxh)

    # -- meshing ---------------------------------------------------------------
    def _sample_segment(self, seg, h):
        """Polyline samples of one segment at arc spacing <= h, endpoints
        included: (pts (k+1, 2), is_endpoint_node_ids)."""
        P = np.asarray(self._points, dtype=np.float64)
        if seg["kind"] == "line":
            a, b = P[seg["nodes"][0]], P[seg["nodes"][1]]
            fn = lambda t: a[None] + np.asarray(t)[:, None] * (b - a)[None]
        else:
            a, c, b = (P[i] for i in seg["nodes"])
            u, v = a - c, b - c
            beta = math.atan2(abs(u[0] * v[1] - u[1] * v[0]), float(u @ v))
            w = math.sin(beta / 2.0)
            fn = lambda t: _spline3_eval(a, c, b, w, t)
        hseg = min(h, seg["maxh"]) if seg["maxh"] else h
        _, total = _arclen_params(fn, 1)
        n = max(1, int(math.ceil(total / hseg)))
        ts, _ = _arclen_params(fn, n)
        return fn(ts)

    def GenerateMesh(self, maxh=0.2, quad_dominated=False, smooth_iters=2):
        """Triangulate the described geometry at target size ``maxh`` and
        return the SoA :class:`Mesh` (``quad_dominated`` is not supported —
        the cut pipeline meshes simplices here, quads come from
        ``MakeStructured2DMesh(quads=True)``)."""
        if quad_dominated:
            raise NotImplementedError(
                "quad_dominated meshing is not supported; use "
                "MakeStructured2DMesh(quads=True) for tensor meshes")
        from scipy.spatial import Delaunay

        h = float(maxh)
        # 1. boundary sampling: global node list, per-segment node chains
        nodes = []           # (x, y)
        node_of_point = {}   # geometry point id -> node id

        def add_node(p):
            nodes.append((float(p[0]), float(p[1])))
            return len(nodes) - 1

        bedges = []          # (n0, n1, bc, left, right) oriented
        for seg in self._segments:
            pts = self._sample_segment(seg, h)
            chain = []
            for k, p in enumerate(pts):
                if k == 0 or k == len(pts) - 1:
                    gp = seg["nodes"][0 if k == 0 else -1]
                    if gp not in node_of_point:
                        node_of_point[gp] = add_node(p)
                    chain.append(node_of_point[gp])
                else:
                    chain.append(add_node(p))
            for a, b in zip(chain[:-1], chain[1:]):
                bedges.append((a, b, seg["bc"], seg["left"], seg["right"]))
        bnodes = np.asarray(nodes, dtype=np.float64)
        nb = len(bnodes)
        be = np.asarray([(e[0], e[1]) for e in bedges], dtype=np.int64)
        ea, eb = bnodes[be[:, 0]], bnodes[be[:, 1]]

        domains = sorted({e[3] for e in bedges} | {e[4] for e in bedges})
        domains = [d for d in domains if d > 0]

        def dom_edges(d):
            """Oriented boundary of domain d: left=d edges as-is, right=d
            reversed (so d is always on the left -> CCW winding +1)."""
            fa, fb = [], []
            for (a, b, _, l, r) in bedges:
                if l == d:
                    fa.append(a); fb.append(b)
                if r == d:
                    fa.append(b); fb.append(a)
            return (bnodes[np.asarray(fa, dtype=np.int64)],
                    bnodes[np.asarray(fb, dtype=np.int64)])

        # 2. hex-lattice interior seeding per domain
        interior = []
        for d in domains:
            hd = min(h, self._dom_maxh.get(d, h))
            da, db = dom_edges(d)
            lo = np.minimum(da.min(0), db.min(0)) + 0.25 * hd
            hi = np.maximum(da.max(0), db.max(0)) - 0.25 * hd
            if (hi <= lo).any():
                continue
            ys = np.arange(lo[1], hi[1] + 1e-12, hd * math.sqrt(3) / 2)
            cand = []
            for j, yv in enumerate(ys):
                xs = np.arange(lo[0] + (hd / 2 if j % 2 else 0.0),
                               hi[0] + 1e-12, hd)
                cand.append(np.stack([xs, np.full_like(xs, yv)], 1))
            if not cand:
                continue
            cand = np.concatenate(cand, 0)
            wn = _winding(cand, da, db)
            cand = cand[np.abs(wn - 1.0) < 0.5]
            if len(cand):
                cand = cand[_seg_dist(cand, ea, eb) >= 0.55 * hd]
            interior.append(cand)
        ipts = (np.concatenate(interior, 0) if interior
                else np.zeros((0, 2)))

        bset = {tuple(sorted(p)) for p in be.tolist()}

        def triangulate(bn, ip):
            pts = np.concatenate([bn, ip], 0)
            tri = Delaunay(pts).simplices.astype(np.int32)
            # orient CCW, drop slivers
            v = pts[tri]
            det = ((v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
                   - (v[:, 1, 1] - v[:, 0, 1]) * (v[:, 2, 0] - v[:, 0, 0]))
            flip = det < 0
            tri[flip] = tri[flip][:, [0, 2, 1]]
            tri = tri[np.abs(det) > 1e-14]
            return pts, tri

        def missing_edges(tri):
            eset = set()
            for i, j in ((0, 1), (1, 2), (0, 2)):
                for p in np.sort(tri[:, (i, j)], axis=1).tolist():
                    eset.add(tuple(p))
            return [p for p in bset if p not in eset]

        # 3. triangulate + boundary-edge recovery (midpoint insertion)
        for _ in range(4):
            pts, tri = triangulate(bnodes, ipts)
            miss = missing_edges(tri)
            if not miss:
                break
            # push the nearest interior point away is fragile; instead split
            # the missing boundary edge at its midpoint (stays on the curve
            # for lines; h^2-close for sampled splines)
            new_b, new_e = [], []
            for (a, b) in miss:
                mid = 0.5 * (bnodes[a] + bnodes[b])
                nid = nb + len(new_b)
                new_b.append(mid)
                for k, (p, q, bc, l, r) in enumerate(bedges):
                    if tuple(sorted((p, q))) == (a, b):
                        bedges[k] = (p, nid, bc, l, r)
                        new_e.append((nid, q, bc, l, r))
                        break
            bedges.extend(new_e)
            bnodes = np.concatenate([bnodes, np.asarray(new_b)], 0)
            nb = len(bnodes)
            be = np.asarray([(e[0], e[1]) for e in bedges], dtype=np.int64)
            ea, eb = bnodes[be[:, 0]], bnodes[be[:, 1]]
            bset = {tuple(sorted(p)) for p in be.tolist()}

        # 4. relaxed Laplacian smoothing of interior nodes + re-Delaunay
        for _ in range(max(0, int(smooth_iters))):
            if len(ipts) == 0:
                break
            nbr_sum = np.zeros_like(pts)
            nbr_cnt = np.zeros(len(pts))
            for i, j in ((0, 1), (1, 2), (0, 2)):
                a, b = tri[:, i], tri[:, j]
                np.add.at(nbr_sum, a, pts[b])
                np.add.at(nbr_sum, b, pts[a])
                np.add.at(nbr_cnt, a, 1)
                np.add.at(nbr_cnt, b, 1)
            tgt = nbr_sum / np.maximum(nbr_cnt, 1)[:, None]
            moved = pts[nb:] + 0.5 * (tgt[nb:] - pts[nb:])
            keep = _seg_dist(moved, ea, eb) >= 0.4 * h
            ipts = np.where(keep[:, None], moved, pts[nb:])
            pts, tri = triangulate(bnodes, ipts)
            if missing_edges(tri):
                pts, tri = triangulate(bnodes, pts[nb:] * 0 + ipts)

        # 5. material classification by centroid winding, drop outside
        cent = pts[tri].mean(1)
        mat = np.zeros(len(tri), dtype=np.int32)
        for d in domains:
            da, db = dom_edges(d)
            inside = np.abs(_winding(cent, da, db) - 1.0) < 0.5
            mat = np.where(inside & (mat == 0), d, mat)
        keep = mat > 0
        tri, mat = tri[keep], mat[keep]
        used = np.unique(tri)
        remap = -np.ones(len(pts), dtype=np.int32)
        remap[used] = np.arange(len(used), dtype=np.int32)
        mesh = Mesh("trig", pts[used], remap[tri], mat_of_el=mat,
                    mat_names=dict(self._materials) or None)

        # 6. bc ids on exterior boundary facets
        bc_of_edge = {}
        for (a, b, bc, _, _) in bedges:
            if a < len(remap) and b < len(remap):
                ra, rb = int(remap[a]), int(remap[b])
                if ra >= 0 and rb >= 0:
                    bc_of_edge[tuple(sorted((ra, rb)))] = bc
        bcf = mesh.bc_of_facet_np.copy()
        for f in mesh.boundary_facets_np:
            key = tuple(sorted(mesh.facets_np[f].tolist()))
            bcf[f] = bc_of_edge.get(key, 1)
        mesh.bc_of_facet_np = bcf
        mesh.bc_names = dict(self._bc_names) or {1: "bc1"}
        return mesh


def MakeCircle(geo, c, r, **kw):
    """netgen.geom2d.MakeCircle analog: add a circle to ``geo``."""
    return geo.AddCircle(c, r, **kw)


def MakeRectangle(geo, p1, p2, **kw):
    """netgen.geom2d.MakeRectangle analog: add a rectangle to ``geo``."""
    return geo.AddRectangle(p1, p2, **kw)
