"""Plain reference of the order-2 isoparametric fictitious-domain system.

Independent of the program under test: it imports neither ``jax`` nor any
package of this repository, and works out the mesh, the level set, the
deformation, the cut geometry, the operator, the load and the solution
again from the benchmark's inputs.

The problem is the reference's ``py_tutorials/fictdom_ghostpen.py`` with
``lsetcurving``'s ``LevelSetMeshAdaptation`` at order 2, in 3D on a box
split into Kuhn tetrahedra (each cube into the six tetrahedra along the
paths from its lowest to its highest corner, the vertices of each in path
order), with order-2 Lagrange elements on the deformed mesh:

- the level set ``phi`` of a sphere, its order-2 nodal interpolant
  ``phi_ho`` and its vertex interpolant ``phi_p1``;
- the deformation ``d``, an order-2 vector field: at every node of an
  element that ``phi_p1`` cuts, eight Newton steps along the physical
  gradient ``q`` of ``phi_ho`` from the node, ``phi_ho(xi + t q_ref) =
  phi_p1(xi)`` (``q_ref = J^-1 q``, ``phi_ho`` the polynomial of the node's
  representative element, extended beyond it), ``d = t q`` clamped to
  ``threshold * h``; zero at every other node.  The mesh's map is then
  ``x(xi) = x_P1(xi) + d(xi)`` on every element;
- the stiffness on the part of each element where ``phi_p1`` is negative,
  the symmetric Nitsche terms ``-(du/dn) v - (dv/dn) u + lam/h u v`` on
  its zero set (``lam = nitsche * order^2``, ``n`` the normalised physical
  gradient of ``phi_p1``), the facet-patch ghost penalty ``gamma/h^2
  int_{T1 u T2} (u1 - u2)(v1 - v2)`` on the interior facets between an
  element with a negative part and a cut element, the load ``int_NEG f v``
  of an affine ``f = a0 + a.x``; ``h = |det J|^(1/3)`` at each point;
- an f64 Jacobi-CG solve on the dofs of the elements with a negative part.

The geometry of the cut is straight in reference coordinates: a cut
element's negative part is split into sub-tetrahedra and its zero set
into triangles by the sign pattern of its (guarded) vertex values, and
every integral is a conical-product (Duffy-collapsed) Gauss rule mapped
into the whole element or into each piece, weighted by ``|det J|`` (and
``|J^-T n_ref|`` on the zero set).  The deformed integrands are not
polynomials, so the rules are the program's by their construction:

- degree ``2 (order - 1)`` for the stiffness, ``2 order`` for the Nitsche
  terms and the ghost penalty, ``2 order + 3`` for the load;
- the decomposition of a cut element by the vertex order: one vertex
  against three, the lone vertex's tetrahedron and the staircase of the
  prism ``(PA PB PC | A B C)``; two against two, a staircase of each wedge
  and the zero set's quad as ``(PAC PBC PBD), (PAC PBD PAD)``; an edge
  point ``(1 - t) V_a + t V_b``, ``t = phi_a / (phi_a - phi_b)`` from the
  first vertex named;
- where the rule depends on an order of the elements, the element first
  in the mesh's order (cell-major, then the Kuhn path; ``order_id``): the
  representative element of a node in the shift, and the first element
  of a facet in the patch, whose map carries ``h`` and whose points are
  found in the other by eight Newton steps on the deformed map from the
  affine guess (a point that does not converge takes the guess).

Departures from ngsxfem (the port's, which this reference follows):

- the deformation is a nodal Newton shift; ngsxfem projects the shift
  element-wise in L2 (``lsetcurving/projshift.cpp:96-113``);
- the rules above are the port's; ngsxfem's cut rule and its integration
  orders under a deformation differ, far above rounding.

Level-set values with ``|phi| < 1e-14`` count as ``+1e-14`` for the cut
geometry.  All arithmetic runs in the dtype the caller gives, on the
device of the inputs, in blocks of at most ``BLOCK_POINTS`` quadrature
points, so the largest cell fits on one card.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EPS = 1e-14
NEWTON_STEPS = 8
BLOCK_POINTS = 1 << 22
# the six Kuhn paths from the lowest to the highest cube corner
_PATHS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
# the edges of a tetrahedron: the local nodes 4..9 of the order-2 basis
EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_REF_VERTS = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
              (0.0, 0.0, 1.0))


# -- rules --------------------------------------------------------------

def _gauss01(n):
    x, w = np.polynomial.legendre.leggauss(max(n, 1))
    return 0.5 * (x + 1.0), 0.5 * w


def _npts(degree):
    return max(1, (degree + 2) // 2)


def tet_rule(degree):
    """Conical-product Gauss rule on the unit tetrahedron, exact to the
    total degree: (points (Q, 3), weights (Q,)), weights summing to 1/6."""
    xi, wx = _gauss01(_npts(degree + 2))
    eta, wy = _gauss01(_npts(degree + 1))
    zeta, wz = _gauss01(_npts(degree))
    X, Y, Z = np.meshgrid(xi, eta, zeta, indexing="ij")
    WX, WY, WZ = np.meshgrid(wx, wy, wz, indexing="ij")
    pts = np.stack([X, Y * (1.0 - X), Z * (1.0 - X) * (1.0 - Y)], -1)
    w = WX * WY * WZ * (1.0 - X) ** 2 * (1.0 - Y)
    return pts.reshape(-1, 3), w.reshape(-1)


def tri_rule(degree):
    """Conical-product Gauss rule on the unit triangle: (points (Q, 2),
    weights (Q,)), weights summing to 1/2."""
    xi, wx = _gauss01(_npts(degree + 1))
    eta, wy = _gauss01(_npts(degree))
    X, Y = np.meshgrid(xi, eta, indexing="ij")
    WX, WY = np.meshgrid(wx, wy, indexing="ij")
    pts = np.stack([X, Y * (1.0 - X)], -1)
    return pts.reshape(-1, 2), (WX * WY * (1.0 - X)).reshape(-1)


def _as(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


# -- the order-2 basis and the deformed map -------------------------------

def bary(xi):
    """Barycentric coordinates (..., 4) of reference points (..., 3)."""
    return torch.stack([1.0 - xi[..., 0] - xi[..., 1] - xi[..., 2],
                        xi[..., 0], xi[..., 1], xi[..., 2]], -1)


def p2(xi):
    """Values (..., 10) and reference gradients (..., 10, 3) of the order-2
    Lagrange basis at reference points xi (..., 3): ``l_v (2 l_v - 1)`` at
    the vertices, then ``4 l_a l_b`` on the edges of ``EDGES``."""
    lam = bary(xi)
    l = [lam[..., k] for k in range(4)]
    dl = _as([[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
              [0.0, 0.0, 1.0]], xi)
    vals = [l[v] * (2.0 * l[v] - 1.0) for v in range(4)]
    vals += [4.0 * l[a] * l[b] for a, b in EDGES]
    grads = [(4.0 * l[v] - 1.0)[..., None] * dl[v] for v in range(4)]
    grads += [4.0 * (l[b][..., None] * dl[a] + l[a][..., None] * dl[b])
              for a, b in EDGES]
    return torch.stack(vals, -1), torch.stack(grads, -2)


def det3(J):
    return (J[..., 0, 0] * (J[..., 1, 1] * J[..., 2, 2]
                            - J[..., 1, 2] * J[..., 2, 1])
            - J[..., 0, 1] * (J[..., 1, 0] * J[..., 2, 2]
                              - J[..., 1, 2] * J[..., 2, 0])
            + J[..., 0, 2] * (J[..., 1, 0] * J[..., 2, 1]
                              - J[..., 1, 1] * J[..., 2, 0]))


def inv3(J, det):
    """Inverse of 3 x 3 matrices by the adjugate."""
    m = J
    rows = [[m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1],
             m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2],
             m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]],
            [m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2],
             m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0],
             m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]],
            [m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0],
             m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1],
             m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]]]
    adj = torch.stack([torch.stack(r, -1) for r in rows], -2)
    return adj / det[..., None, None]


class Mesh:
    """Kuhn tetrahedra of the box [lo, hi]^3 with ``nx`` cells per axis and
    the nodes of the order-2 elements on them.

    Vertex ``(i, j, k)`` has id ``(i * (nx + 1) + j) * (nx + 1) + k``;
    element ``path * nx^3 + cell``.  Every point of the doubled lattice is
    one order-2 node (a vertex, or the midpoint of one edge: Kuhn
    tetrahedra split each face of a cube along one diagonal), node ``(I,
    J, K)`` with id ``(I * (2 nx + 1) + J) * (2 nx + 1) + K``.  ``enodes``
    (ne, 10): the nodes of each element in the basis order of ``p2``;
    ``order_id`` the element's place in the mesh's order (cell-major, then
    the path); ``facets`` (F, 2) the element pairs of the interior
    facets."""

    def __init__(self, nx, lo, hi, device):
        self.nx, self.lo, self.hi = nx, lo, hi
        n1 = nx + 1
        self.nv = n1 ** 3
        axis = torch.as_tensor(np.linspace(lo, hi, n1), dtype=torch.float64)
        ii, jj, kk = torch.meshgrid(axis, axis, axis, indexing="ij")
        self.X = torch.stack([ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)],
                             1).to(device)
        c = torch.arange(nx, device=device)
        ci, cj, ck = (t.reshape(-1) for t in
                      torch.meshgrid(c, c, c, indexing="ij"))
        tets = []
        for path in _PATHS:
            corner = [ci, cj, ck]
            verts = [(corner[0] * n1 + corner[1]) * n1 + corner[2]]
            for ax in path:
                corner = [t + (1 if a == ax else 0) for a, t in
                          enumerate(corner)]
                verts.append((corner[0] * n1 + corner[1]) * n1 + corner[2])
            tets.append(torch.stack(verts, 1))
        self.tets = torch.cat(tets, 0)
        self.ne = self.tets.shape[0]
        ncell = nx ** 3
        e = torch.arange(self.ne, device=device)
        self.order_id = (e % ncell) * 6 + e // ncell
        self.facets = _interior_facets(self.tets, self.nv)
        # order-2 nodes on the doubled lattice
        N1 = 2 * nx + 1
        self.N1, self.nn = N1, N1 ** 3
        vijk = torch.stack([self.tets // (n1 * n1), self.tets // n1 % n1,
                            self.tets % n1], 2)  # (ne, 4, 3)
        nijk = torch.cat([2 * vijk] + [vijk[:, a, None] + vijk[:, b, None]
                                      for a, b in EDGES], 1)
        self.enodes = (nijk[..., 0] * N1 + nijk[..., 1]) * N1 + nijk[..., 2]
        ax2 = torch.as_tensor(np.linspace(lo, hi, N1), dtype=torch.float64)
        I, J, K = torch.meshgrid(ax2, ax2, ax2, indexing="ij")
        self.Xn = torch.stack([I.reshape(-1), J.reshape(-1), K.reshape(-1)],
                              1).to(device)
        # the representative element of each node: first in the mesh's
        # order among those holding it, and the node's slot there
        big = torch.full((self.nn,), self.ne * 6, dtype=torch.int64,
                         device=device)
        first = big.scatter_reduce(0, self.enodes.reshape(-1),
                                   self.order_id.repeat_interleave(10),
                                   "amin")
        self.rep = (first % 6) * ncell + first // 6
        node = torch.arange(self.nn, device=device)
        self.rep_slot = (self.enodes[self.rep] == node[:, None]).to(
            torch.int64).argmax(1)

    def with_dtype(self, dtype):
        """The same mesh with its coordinates in ``dtype``."""
        other = object.__new__(Mesh)
        other.__dict__.update(self.__dict__)
        other.X, other.Xn = self.X.to(dtype), self.Xn.to(dtype)
        return other

    @property
    def h(self):
        return (self.hi - self.lo) / self.nx


def _interior_facets(tets, nv):
    """(F, 2) element pairs that share a facet."""
    ne = tets.shape[0]
    faces = torch.cat([tets[:, [1, 2, 3]], tets[:, [0, 2, 3]],
                       tets[:, [0, 1, 3]], tets[:, [0, 1, 2]]], 0)
    faces, _ = torch.sort(faces, 1)
    key = (faces[:, 0] * nv + faces[:, 1]) * nv + faces[:, 2]
    owner = torch.arange(ne, device=tets.device).repeat(4)
    key, order = torch.sort(key)
    owner = owner[order]
    same = key[1:] == key[:-1]
    return torch.stack([owner[:-1][same], owner[1:][same]], 1)


# the reference coordinates of the local nodes of ``p2``
_SLOT_XI = (list(_REF_VERTS)
            + [tuple(0.5 * (_REF_VERTS[a][i] + _REF_VERTS[b][i])
                     for i in range(3)) for a, b in EDGES])


def element_map(m, D, ids, xi):
    """The deformed map of elements ``ids`` (R,) at reference points xi
    (R, Q, 3): (basis values (R, Q, 10), reference gradients (R, Q, 10, 3),
    physical points (R, Q, 3), det J (R, Q), J^-1 (R, Q, 3, 3))."""
    X = m.X[m.tets[ids]]  # (R, 4, 3)
    Dn = D[m.enodes[ids]]  # (R, 10, 3)
    psi, dpsi = p2(xi)
    phys = (torch.einsum("rqk,rkg->rqg", bary(xi), X)
            + torch.einsum("rqm,rmg->rqg", psi, Dn))
    Jaff = (X[:, 1:] - X[:, :1]).transpose(1, 2)  # column d: X_d+1 - X_0
    J = Jaff[:, None] + torch.einsum("rmg,rqmd->rqgd", Dn, dpsi)
    det = det3(J)
    return psi, dpsi, phys, det, inv3(J, det)


def guard(phi):
    return torch.where(phi.abs() < EPS, torch.full_like(phi, EPS), phi)


def classify(m, phi_v):
    """(has a negative part, cut) element masks of the guarded vertex
    values."""
    g = guard(phi_v[m.tets])
    hasneg = (g < 0).any(1)
    return hasneg, hasneg & (g > 0).any(1)


def _blocks(n, q):
    step = max(1, BLOCK_POINTS // max(q, 1))
    return [slice(i, min(n, i + step)) for i in range(0, n, step)]


# -- the deformation ------------------------------------------------------

def deformation(m, phi_n, phi_v, cut, threshold):
    """(nn, 3) node shifts: the Newton shift at every node of a cut
    element, zero elsewhere."""
    dt, dev = m.X.dtype, m.X.device
    mark = torch.zeros(m.nn, dtype=torch.bool, device=dev)
    mark[m.enodes[cut].reshape(-1)] = True
    act = torch.nonzero(mark)[:, 0]
    D = torch.zeros(m.nn, 3, dtype=dt, device=dev)
    slot_xi = _as(_SLOT_XI, m.X)
    for s in _blocks(act.numel(), 16 * NEWTON_STEPS):
        nodes = act[s]
        e = m.rep[nodes]
        X = m.X[m.tets[e]]
        J = (X[:, 1:] - X[:, :1]).transpose(1, 2)
        det = det3(J)
        Jinv = inv3(J, det)
        h = det.abs() ** (1.0 / 3.0)
        ho = phi_n[m.enodes[e]]  # (M, 10)
        xi0 = slot_xi[m.rep_slot[nodes]]  # (M, 3)

        def at(xi):
            psi, dpsi = p2(xi)
            return (psi * ho).sum(-1), (dpsi * ho[..., None]).sum(-2)

        _, g0 = at(xi0)
        q = torch.einsum("md,mdg->mg", g0, Jinv)  # physical gradient
        q_ref = torch.einsum("mdg,mg->md", Jinv, q)
        goal = (bary(xi0) * phi_v[m.tets[e]]).sum(-1)
        t = torch.zeros_like(goal)
        for _ in range(NEWTON_STEPS):
            val, g = at(xi0 + t[:, None] * q_ref)
            dphi = (g * q_ref).sum(-1)
            dphi = torch.where(dphi.abs() < 1e-30, torch.ones_like(dphi),
                               dphi)
            t = t - (val - goal) / dphi
        disp = t[:, None] * q
        dn = torch.linalg.vector_norm(disp, dim=1)
        lim = threshold * h
        scale = torch.where(dn > lim, lim / torch.where(
            dn < 1e-30, torch.ones_like(dn), dn), torch.ones_like(dn))
        D[nodes] = disp * scale[:, None]
    return D


# -- the cut ----------------------------------------------------------------

def _pieces(p):
    """Sign pattern ``p`` (bit v set: vertex v positive) of a cut
    tetrahedron -> (negative sub-tetrahedra, zero-set triangles), each
    point a pair ``(a, b)``: vertex a where a == b, else the zero on the
    edge from a to b."""
    neg = [v for v in range(4) if not (p >> v) & 1]
    pos = [v for v in range(4) if (p >> v) & 1]
    V = lambda a: (a, a)  # noqa: E731
    if len(neg) in (1, 3):
        lone, (A, B, C) = (neg[0], pos) if len(neg) == 1 else (pos[0], neg)
        PA, PB, PC = (lone, A), (lone, B), (lone, C)
        tip = [(V(lone), PA, PB, PC)]
        prism = [(PA, PB, PC, V(A)), (PB, PC, V(A), V(B)),
                 (PC, V(A), V(B), V(C))]
        return (tip if len(neg) == 1 else prism), [(PA, PB, PC)]
    (A, B), (C, D) = neg, pos
    PAC, PAD, PBC, PBD = (A, C), (A, D), (B, C), (B, D)
    negs = [(V(A), PAC, PAD, V(B)), (PAC, PAD, V(B), PBC),
            (PAD, V(B), PBC, PBD)]
    return negs, [(PAC, PBC, PBD), (PAC, PBD, PAD)]


def _point(g, spec, refv):
    """Reference coordinates (B, 3) of a piece's point in elements with
    guarded vertex values g (B, 4)."""
    a, b = spec
    if a == b:
        return refv[a].expand(g.shape[0], 3)
    den = g[:, a] - g[:, b]
    den = torch.where(den.abs() < 1e-30, torch.ones_like(den), den)
    t = (g[:, a] / den).clamp(0.0, 1.0)[:, None]
    return (1.0 - t) * refv[a] + t * refv[b]


def _simplex_rule(P, rp, rw):
    """A rule (points (Q, k), weights (Q,)) of the unit k-simplex mapped into
    the simplices with vertices P (list of k + 1 (B, 3)): (points (B, Q, 3),
    weights (B, Q))."""
    E = [p - P[0] for p in P[1:]]
    pts = P[0][:, None] + sum(rp[:, k, None] * E[k][:, None]
                              for k in range(len(E)))
    if len(E) == 3:
        scale = det3(torch.stack(E, 1)).abs()
    else:
        scale = torch.linalg.vector_norm(
            torch.linalg.cross(E[0], E[1], dim=1), dim=1)
    return pts, scale[:, None] * rw


def cut_rules(g, tet, tri):
    """The rules of cut elements with guarded vertex values g (B, 4):
    (rows, negative-part points (b, Q, 3) and weights for each rule of
    ``tet`` (a list of (points, weights) on the unit tetrahedron), zero-set
    points (b, Q', 3), weights and unit reference normals (b, 3)) for
    each sign pattern present."""
    refv = _as(_REF_VERTS, g)
    pattern = ((g > 0).to(torch.int64)
               * torch.tensor([1, 2, 4, 8], device=g.device)).sum(1)
    out = []
    for p in range(1, 15):
        rows = torch.nonzero(pattern == p)[:, 0]
        if not rows.numel():
            continue
        gp = g[rows]
        negs, tris = _pieces(p)
        vol = []
        for rp, rw in tet:
            parts = [_simplex_rule([_point(gp, s, refv) for s in piece],
                                   rp, rw) for piece in negs]
            vol.append((torch.cat([q for q, _ in parts], 1),
                        torch.cat([w for _, w in parts], 1)))
        ip, iw = tri
        parts = [_simplex_rule([_point(gp, s, refv) for s in piece], ip, iw)
                 for piece in tris]
        dv = gp[:, 1:] - gp[:, :1]
        nref = dv / torch.linalg.vector_norm(dv, dim=1, keepdim=True)
        out.append((rows, vol, torch.cat([q for q, _ in parts], 1),
                    torch.cat([w for _, w in parts], 1), nref))
    return out


# -- the element systems ----------------------------------------------------

def _affine(load, P):
    a0, a = load
    return a0 + P @ _as(a, P)


def _volume(m, D, ids, xi, w, load=None):
    """Stiffness (R, 10, 10), or with ``load`` the load vectors (R, 10), of
    the rule (xi (R, Q, 3), reference weights (R, Q)) on elements ids."""
    psi, dpsi, phys, det, Jinv = element_map(m, D, ids, xi)
    W = w * det.abs()
    if load is not None:
        return torch.einsum("rq,rqi->ri", W * _affine(load, phys), psi)
    G = torch.einsum("rqmd,rqdg->rqmg", dpsi, Jinv)
    return torch.einsum("rq,rqig,rqjg->rij", W, G, G)


def _nitsche(m, D, ids, xi, w, nref, gp1, lam_c):
    """Nitsche matrices (R, 10, 10) on the zero-set rule (xi, w) of
    elements ids: ``nref`` the unit reference normal of the rule, ``gp1``
    (R, 3) the reference gradient of ``phi_p1``."""
    psi, dpsi, _, det, Jinv = element_map(m, D, ids, xi)
    JT = Jinv.transpose(-1, -2)
    scale = torch.linalg.vector_norm(
        torch.einsum("rqgd,rd->rqg", JT, nref), dim=-1)
    gphys = torch.einsum("rqgd,rd->rqg", JT, gp1)
    n = gphys / torch.linalg.vector_norm(gphys, dim=-1, keepdim=True)
    W = w * det.abs() * scale
    lam = lam_c / det.abs() ** (1.0 / 3.0)
    G = torch.einsum("rqmd,rqdg->rqmg", dpsi, Jinv)
    dn = torch.einsum("rqmg,rqg->rqm", G, n)
    A = torch.einsum("rq,rqi,rqj->rij", W * lam, psi, psi)
    B = torch.einsum("rq,rqi,rqj->rij", W, psi, dn)
    return A - B - B.transpose(1, 2)


def _patch_map(m, D, e_from, e_to, xi):
    """Reference points in ``e_to`` (F, Q, 3) of the deformed images of the
    points xi (F, Q, 3) of ``e_from``: Newton on the deformed map of
    ``e_to`` from the affine guess of its undeformed map; a point that does
    not converge takes the guess."""
    target = element_map(m, D, e_from, xi)[2]
    X = m.X[m.tets[e_to]]
    Jaff = (X[:, 1:] - X[:, :1]).transpose(1, 2)
    detc = det3(Jaff)
    Jcinv = inv3(Jaff, detc)
    centre = X.mean(1)
    x0 = torch.einsum("fdg,fqg->fqd", Jcinv, target - centre[:, None]) + 0.25
    x = x0
    for _ in range(NEWTON_STEPS):
        _, _, p, _, Jinv = element_map(m, D, e_to, x)
        x = x + torch.einsum("fqdg,fqg->fqd", Jinv, target - p)
    p = element_map(m, D, e_to, x)[2]
    err = torch.linalg.vector_norm(target - p, dim=-1)
    tol = 1e4 * torch.finfo(xi.dtype).eps * detc.abs() ** (1.0 / 3.0)
    return torch.where((err <= tol[:, None])[..., None], x, x0)


def _ghost(m, D, e1, e2, base, rw, gamma):
    """Ghost-penalty matrices (F, 20, 20) on the element pairs (e1, e2), the
    rule (base, rw) of degree ``2 order`` on each."""
    F = e1.numel()
    b = base[None].expand(F, -1, -1)
    in2 = _patch_map(m, D, e1, e2, b)
    in1 = _patch_map(m, D, e2, e1, b)
    self_pts = torch.cat([b, in1], 1)
    other_pts = torch.cat([in2, b], 1)
    psi1, _, _, det1, _ = element_map(m, D, e1, self_pts)
    psi2, _, _, det2, _ = element_map(m, D, e2, other_pts)
    nq = base.shape[0]
    W = torch.cat([det1[:, :nq].abs() * rw, det2[:, nq:].abs() * rw], 1)
    h = det1.abs() ** (1.0 / 3.0)
    Fm = torch.cat([psi1, -psi2], 2)
    return torch.einsum("fq,fqi,fqj->fij", W * (gamma / (h * h)), Fm, Fm)


class System:
    """The assembled reference: COO triplets on the ``nn`` nodes, load,
    element masks, the dof mask and the deformation."""

    def __init__(self, n, rows, cols, vals, rhs, hasneg, cut, active, D):
        self.n, self.rows, self.cols, self.vals = n, rows, cols, vals
        self.rhs, self.hasneg, self.cut, self.active = rhs, hasneg, cut, active
        self.D = D

    def csr(self):
        """The operator as a CSR tensor, duplicates summed."""
        with warnings.catch_warnings():  # sparse CSR support is in beta
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_coo_tensor(torch.stack([self.rows, self.cols]),
                                        self.vals, (self.n, self.n)
                                        ).coalesce()
            return A.to_sparse_csr()

    def matvec(self, x):
        y = torch.zeros(self.n, dtype=self.vals.dtype, device=x.device)
        return y.index_add_(0, self.rows, self.vals * x[self.cols])


def assemble(m, centre, radius, order, nitsche, gamma, load, threshold):
    """The reference system of a sphere at ``centre``, in the dtype of the
    mesh's coordinates."""
    if order != 2:
        raise ValueError("the reference is of order-2 elements")
    c = _as(centre, m.X)
    phi_v = torch.linalg.vector_norm(m.X - c, dim=1) - radius
    phi_n = torch.linalg.vector_norm(m.Xn - c, dim=1) - radius
    hasneg, cut = classify(m, phi_v)
    D = deformation(m, phi_n, phi_v, cut, threshold)
    lam_c = nitsche * order * order
    # the degrees of the stiffness, the load, the Nitsche terms and patch
    k_a, k_f, k_g = 2 * order - 2, 2 * order + 3, 2 * order
    rules = {k: tuple(_as(a, m.X) for a in tet_rule(k))
             for k in (k_a, k_f, k_g)}
    mats, mdofs, vecs, vdofs = [], [], [], []

    def add_mats(ids, A):
        mats.append(A.reshape(-1))
        mdofs.append(m.enodes[ids])

    def add_vecs(ids, f):
        vecs.append(f.reshape(-1))
        vdofs.append(m.enodes[ids].reshape(-1))

    # the whole negative elements
    whole = torch.nonzero(hasneg & ~cut)[:, 0]
    for k, is_load in ((k_a, False), (k_f, True)):
        rp, rw = rules[k]
        for s in _blocks(whole.numel(), rw.numel()):
            ids = whole[s]
            xi = rp[None].expand(ids.numel(), -1, -1)
            w = rw[None].expand(ids.numel(), -1)
            if is_load:
                add_vecs(ids, _volume(m, D, ids, xi, w, load))
            else:
                add_mats(ids, _volume(m, D, ids, xi, w))
    # the cut elements: negative part and zero set
    cuts = torch.nonzero(cut)[:, 0]
    ip, iw = (_as(a, m.X) for a in tri_rule(k_g))
    for s in _blocks(cuts.numel(), 6 * rules[k_f][1].numel()):
        ids = cuts[s]
        g = guard(phi_v[m.tets[ids]])
        raw = phi_v[m.tets[ids]]
        for rows, vol, xi_if, w_if, nref in cut_rules(
                g, [rules[k_a], rules[k_f]], (ip, iw)):
            e = ids[rows]
            (xa, wa), (xf, wf) = vol
            A = _volume(m, D, e, xa, wa)
            gp1 = raw[rows, 1:] - raw[rows, :1]
            A = A + _nitsche(m, D, e, xi_if, w_if, nref, gp1, lam_c)
            add_mats(e, A)
            add_vecs(e, _volume(m, D, e, xf, wf, load))
    # the ghost penalty on the facets between HASNEG and cut elements
    e1, e2 = m.facets[:, 0], m.facets[:, 1]
    sel = (hasneg[e1] & cut[e2]) | (cut[e1] & hasneg[e2])
    e1, e2 = e1[sel], e2[sel]
    swap = m.order_id[e1] > m.order_id[e2]
    e1, e2 = torch.where(swap, e2, e1), torch.where(swap, e1, e2)
    base, rw = rules[k_g]
    gmats, gdofs = [], []
    for s in _blocks(e1.numel(), 4 * rw.numel() * (NEWTON_STEPS + 2)):
        gmats.append(_ghost(m, D, e1[s], e2[s], base, rw, gamma
                            ).reshape(-1))
        gdofs.append(torch.cat([m.enodes[e1[s]], m.enodes[e2[s]]], 1))
    rows, cols = [], []
    for d, k in [(x, 10) for x in mdofs] + [(x, 20) for x in gdofs]:
        rows.append(d[:, :, None].expand(-1, k, k).reshape(-1))
        cols.append(d[:, None, :].expand(-1, k, k).reshape(-1))
    vals = mats + gmats
    rhs = torch.zeros(m.nn, dtype=m.X.dtype, device=m.X.device)
    rhs.index_add_(0, torch.cat(vdofs), torch.cat(vecs))
    active = torch.zeros(m.nn, dtype=torch.bool, device=m.X.device)
    active[m.enodes[hasneg].reshape(-1)] = True
    return System(m.nn, torch.cat(rows), torch.cat(cols), torch.cat(vals),
                  rhs, hasneg, cut, active, D)


def pcg(A, b, free, tol, maxiter, check_every=25):
    """Jacobi-preconditioned CG on the free rows of the CSR matrix ``A``
    (zero elsewhere).  Returns (x, iterations, relative residual of the
    recurrence)."""
    n = b.shape[0]
    diag = torch.zeros(n, dtype=b.dtype, device=b.device)
    crow, col, val = A.crow_indices(), A.col_indices(), A.values()
    rowid = torch.repeat_interleave(torch.arange(n, device=b.device),
                                    crow[1:] - crow[:-1])
    on = rowid == col
    diag[rowid[on]] = val[on].to(b.dtype)
    dinv = torch.where(free & (diag != 0), 1.0 / diag, torch.zeros_like(diag))

    def mv(x):
        y = (A @ torch.where(free, x, 0.0)[:, None])[:, 0]
        return torch.where(free, y, 0.0)

    x = torch.zeros_like(b)
    r = torch.where(free, b, 0.0)
    bn = torch.linalg.vector_norm(r)
    z = dinv * r
    p = z
    rz = torch.dot(r, z)
    k = 0
    rel = 1.0
    while k < maxiter:
        Ap = mv(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
        if k % check_every == 0:
            rel = float(torch.linalg.vector_norm(r) / bn)
            if rel <= tol:
                break
    return x, k, rel
