"""Plain reference of one space-time CutFEM slab on a moving sphere.

Independent of the program under test: it imports neither ``jax`` nor any
package of this repository, and works out the marks, the operator, the
load and the solution of one time slab again from the benchmark's inputs
(the sphere's centre at the slab's bottom and top, and the solution at the
bottom that the slab starts from), on the Kuhn mesh and interior facets of
``cutp1.Lattice``, which the caller passes in.

The problem is the reference's ``py_tutorials/moving_domain.py``
(convection-diffusion on a moving domain, space-time CutFEM slab by slab):
on the slab ``[t_k, t_k + dt]``, in the reference time ``s`` in [0, 1],
with the space ``P1 (space) x P1 (time, nodes 0 and 1)``, find ``u`` with

    int_Q  dt(u) v + dt (w.grad(u) v + grad(u).grad(v))         (volume)
  + int_{Omega(0)} u(0) v(0)                              (bottom, upwind)
  + dt / h^2 int_0^1 int_{T1 u T2} (u1 - u2)(v1 - v2)   (facet-patch GP)
  = int_Q dt f v + int_{Omega(0)} u_old v(0),

``Q`` the space-time region where the level set is negative, ``Omega(0)``
its bottom.  Departures from the tutorial, as the benchmark's
configuration states them:

- 3D: the box [-1, 1]^3 in Kuhn tetrahedra (the tutorial is 2D);
- the sphere ``|x - c(s)| = R`` with ``c(s) = c_bot + s (c_top - c_bot)``,
  one chord of the benchmark's walk per slab, so ``w = (c_top - c_bot) /
  dt`` on the slab;
- the manufactured solution ``u = (rho^2 - R^2)^2 / R^4``, ``rho = |x -
  c|``, transported rigidly, and ``f = -lap(u) = -(20 rho^2 - 12 R^2) /
  R^4``;
- the level set is the P1 interpolant in space of its values at the time
  nodes, linear in time on each vertex;
- an element has a negative (positive) part where a vertex value at time 0
  or 1 is negative (positive): in P1 x P1 the extremes lie at the nodes;
  it is cut where it has both; the active dofs are those of the elements
  with a negative part, at both time nodes;
- the ghost penalty acts on the interior facets between an element with a
  negative part and a cut element, with factor 1, its time integral exact
  (the tutorial's time order 2 k_t = 2);
- the space-time volume integrals are taken, on every element with a
  negative part, on the slices of [0, 1] between the roots of the vertex
  values (linear in time), by the two-point Gauss rule on each slice (time
  order 3), and at each time point exactly in space over the straight cut
  of the tetrahedron;
- the bottom integrals are exact over the straight cut at time 0;
- the solve is a direct one of the non-symmetric active block, made dense
  (LU with partial pivoting), in the dtype of the inputs.

Level-set values with ``|phi| < 1e-14`` count as ``+1e-14`` for the cut
geometry, at the nodes and at each time point, as in the reference's
straight and space-time cut rules.  All arithmetic runs in the dtype of
the lattice's coordinates, on their device.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-14
# the two-point Gauss rule on [0, 1]
_G = (0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0))
# (1 / |T|) int_T N_n lambda_k of the order-2 nodal basis N_n (vertices 0-3,
# then the edges of _EDGES) against the barycentric coordinates
_EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _p2_moments(dtype, device):
    Q = torch.full((10, 4), -1.0 / 60.0, dtype=dtype, device=device)
    Q[torch.arange(4), torch.arange(4)] = 0.0
    for n, (a, b) in enumerate(_EDGES):
        Q[4 + n] = 1.0 / 30.0
        Q[4 + n, a] = Q[4 + n, b] = 1.0 / 15.0
    return Q


def guard(phi):
    return torch.where(phi.abs() < EPS, torch.full_like(phi, EPS), phi)


def _geometry(X):
    """Barycentric gradients (E, 4, 3), volumes (E,) and inverse of the
    barycentric map (E, 4, 4) of tetrahedra with corners X (E, 4, 3)."""
    M = torch.cat([torch.ones_like(X[:, :, :1]), X], 2).transpose(1, 2)
    Minv = torch.linalg.inv(M)
    return Minv[:, :, 1:], torch.linalg.det(M).abs() / 6.0, Minv


def _bary_at(Minv, P):
    """Barycentric coordinates (E, k, 4) of points P (E, k, 3) in the
    tetrahedra of the inverse maps Minv (E, 4, 4)."""
    Ph = torch.cat([torch.ones_like(P[:, :, :1]), P], 2)
    return (Minv[:, None] @ Ph[:, :, :, None])[..., 0]


def _neg_tets(g):
    """The straight cut of tetrahedra with guarded corner values ``g`` (r,
    4), none of one sign only: for each number k of negative corners, its
    rows and the tetrahedra that fill the negative part, each as its four
    corners in barycentric coordinates (r_k, 4, 4)."""
    order = torch.argsort(g, 1)  # negative corners first
    eye = torch.eye(4, dtype=g.dtype, device=g.device)
    m = (g < 0).sum(1)
    out = []
    for k in (1, 2, 3):
        rows = torch.nonzero(m == k)[:, 0]
        if not rows.numel():
            continue
        o = order[rows]
        gk = g[rows].gather(1, o)  # values in sorted order
        c = [eye[o[:, j]] for j in range(4)]

        def zero(a, b):  # the level set's zero on the edge a-b
            t = (gk[:, a] / (gk[:, a] - gk[:, b]))[:, None]
            return (1.0 - t) * c[a] + t * c[b]

        if k == 1:
            pieces = [(c[0], zero(0, 1), zero(0, 2), zero(0, 3))]
        elif k == 2:  # the prism between the edges 0-2, 0-3 and 1-2, 1-3
            A = (c[0], zero(0, 2), zero(0, 3))
            B = (c[1], zero(1, 2), zero(1, 3))
            pieces = [(A[0], A[1], A[2], B[2]), (A[0], A[1], B[1], B[2]),
                      (A[0], B[0], B[1], B[2])]
        else:  # the prism between the face 0-1-2 and the cut of corner 3
            A = (c[0], c[1], c[2])
            B = (zero(0, 3), zero(1, 3), zero(2, 3))
            pieces = [(A[0], A[1], A[2], B[2]), (A[0], A[1], B[1], B[2]),
                      (A[0], B[0], B[1], B[2])]
        out.append((rows, [torch.stack(p, 1) for p in pieces]))
    return out


def marks(lat, phi0, phi1):
    """(has a negative part, cut) element masks of the slab whose vertex
    values at the time nodes 0 and 1 are ``phi0``, ``phi1``."""
    g = torch.stack([guard(phi0[lat.tets]), guard(phi1[lat.tets])], 1)
    hasneg = (g < 0).flatten(1).any(1)
    return hasneg, hasneg & (g > 0).flatten(1).any(1)


def _pieces(g):
    """NEG sub-tetrahedra of the elements with vertex values ``g`` (e, 4),
    guarded: a list of (rows, barycentric corners (r, 4 points, 4))."""
    out = []
    neg = (g < 0).all(1)
    rows = torch.nonzero(neg)[:, 0]
    if rows.numel():
        out.append((rows, torch.eye(4, dtype=g.dtype, device=g.device)
                    .expand(rows.numel(), 4, 4)))
    cut = torch.nonzero((g < 0).any(1) & ~neg)[:, 0]
    if cut.numel():
        for rows, tets in _neg_tets(g[cut]):
            for Lam in tets:
                out.append((cut[rows], Lam))
    return out


def _neg_moments(g, X, vol, fn=None):
    """Over the NEG part of each element (guarded vertex values ``g`` (e,
    4), corners ``X`` (e, 4, 3), volumes ``vol``): its measure (e,), the
    integrals of the barycentric coordinates (e, 4), of their products (e,
    4, 4) and, with ``fn`` (points (r, k, 3) -> values (r, k), a quadratic
    in space, ``rows``), of ``fn`` times each coordinate (e, 4)."""
    e = g.shape[0]
    V = torch.zeros(e, dtype=g.dtype, device=g.device)
    m = torch.zeros(e, 4, dtype=g.dtype, device=g.device)
    M = torch.zeros(e, 4, 4, dtype=g.dtype, device=g.device)
    F = torch.zeros(e, 4, dtype=g.dtype, device=g.device)
    Q = _p2_moments(g.dtype, g.device)
    for rows, Lam in _pieces(g):
        w = torch.linalg.det(Lam).abs() * vol[rows]
        S = Lam.sum(1)
        V.index_add_(0, rows, w)
        m.index_add_(0, rows, w[:, None] / 4.0 * S)
        M.index_add_(0, rows, w[:, None, None] / 20.0 * (
            Lam.transpose(1, 2) @ Lam + S[:, :, None] * S[:, None, :]))
        if fn is not None:
            # the sub-tetrahedron's order-2 nodes: its corners, its edges'
            # midpoints; fn is exact in that space
            mid = torch.stack([0.5 * (Lam[:, a] + Lam[:, b])
                               for a, b in _EDGES], 1)
            nodes = torch.cat([Lam, mid], 1) @ X[rows]  # (r, 10, 3)
            fv = fn(nodes, rows)
            F.index_add_(0, rows,
                         w[:, None] * ((fv @ Q)[:, None, :] @ Lam)[:, 0])
    return V, m, M, F


def _slices(g0, g1):
    """Time points (e, 10) and weights (e, 10) of the two-point Gauss rule
    on each slice of [0, 1] between the vertex roots of the guarded vertex
    values ``g0``, ``g1`` (e, 4) at the time nodes."""
    flips = (g0 < 0) != (g1 < 0)
    root = torch.where(flips, g0 / torch.where(flips, g0 - g1, 1.0),
                       torch.zeros_like(g0))
    edges = torch.sort(torch.cat([torch.zeros_like(g0[:, :1]), root,
                                  torch.ones_like(g0[:, :1])], 1), 1)[0]
    t0, ln = edges[:, :-1], edges[:, 1:] - edges[:, :-1]
    pts = torch.stack([t0 + ln * q for q in _G], 2).flatten(1)
    wts = torch.stack([0.5 * ln, 0.5 * ln], 2).flatten(1)
    return pts, wts


class System:
    """The assembled slab: COO triplets on the space-time nodes (node ``v``
    at time node ``a`` is ``a * nv + v``), load, masks."""

    def __init__(self, lat, rows, cols, vals, rhs, hasneg, cut, active):
        self.lat, self.rows, self.cols, self.vals = lat, rows, cols, vals
        self.rhs, self.hasneg, self.cut, self.active = rhs, hasneg, cut, active
        self.n = 2 * lat.nv

    def matvec(self, x):
        y = torch.zeros(self.n, dtype=self.vals.dtype, device=x.device)
        return y.index_add_(0, self.rows, self.vals * x[self.cols])


def assemble(lat, c_bot, c_top, radius, dt, gamma, uold):
    """The slab's system.  ``c_bot``, ``c_top``: the centre at the slab's
    bottom and top; ``uold`` (nv,): the solution at the bottom; the dtype
    of ``lat.X`` is the arithmetic's."""
    # float32 products in float32, not TF32 (the control's precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    X, dtype, dev = lat.X, lat.X.dtype, lat.X.device
    nv = lat.nv
    cb = torch.as_tensor(c_bot, dtype=dtype, device=dev)
    ct = torch.as_tensor(c_top, dtype=dtype, device=dev)
    R2 = radius * radius
    phi0 = torch.linalg.vector_norm(X - cb, dim=1) - radius
    phi1 = torch.linalg.vector_norm(X - ct, dim=1) - radius
    hasneg, cut = marks(lat, phi0, phi1)
    ids = torch.nonzero(hasneg)[:, 0]
    tets = lat.tets[ids]
    Xe = X[tets]
    G, vol, _ = _geometry(Xe)
    GG = G @ G.transpose(1, 2)
    wG = G @ ((ct - cb) / dt)  # (e, 4): w . grad(phi_j)
    g0, g1 = guard(phi0[tets]), guard(phi1[tets])
    e = ids.numel()

    # the space-time volume: A[(a, i), (b, j)] on 2 x 4 slots, time major
    A = torch.zeros(e, 2, 4, 2, 4, dtype=dtype, device=dev)
    Fv = torch.zeros(e, 2, 4, dtype=dtype, device=dev)
    tp, tw = _slices(g0, g1)
    for k in range(tp.shape[1]):
        s, om = tp[:, k], tw[:, k]
        c = cb + s[:, None] * (ct - cb)  # (e, 3)

        def f(P, rows, c=c):
            rho2 = ((P - c[rows][:, None, :]) ** 2).sum(2)
            return -(20.0 * rho2 - 12.0 * R2) / (R2 * R2)

        V, m, M, F = _neg_moments(guard(g0 + s[:, None] * (g1 - g0)), Xe,
                                  vol, f)
        th = torch.stack([1.0 - s, s], 1)  # (e, 2) time basis
        dth = torch.tensor([-1.0, 1.0], dtype=dtype, device=dev)
        # test (a, i), trial (b, j)
        mass = (om[:, None, None, None, None] * th[:, :, None, None, None]
                * dth[None, None, None, :, None] * M[:, None, :, None, :])
        space = (m[:, :, None] * wG[:, None, :]
                 + V[:, None, None] * GG)  # (e, 4 test, 4 trial)
        A += mass + dt * (om[:, None, None, None, None]
                          * th[:, :, None, None, None]
                          * th[:, None, None, :, None]
                          * space[:, None, :, None, :])
        Fv += dt * om[:, None, None] * th[:, :, None] * F[:, None, :]

    # the bottom: time node 0 only (the time basis is 1, 0 there)
    _, _, Mb, _ = _neg_moments(g0, Xe, vol)
    A[:, 0, :, 0, :] += Mb
    Fv[:, 0, :] += (Mb @ uold[tets].to(dtype)[:, :, None])[:, :, 0]

    st = torch.cat([tets, tets + nv], 1)  # (e, 8) space-time nodes
    A = A.reshape(e, 8, 8)
    rows = [st[:, :, None].expand(-1, 8, 8).reshape(-1)]
    cols = [st[:, None, :].expand(-1, 8, 8).reshape(-1)]
    vals = [A.reshape(-1)]

    # the facet-patch ghost penalty, its time integral exact: int_0^1 of
    # the products of the time basis 1 - s, s
    e1, e2 = lat.facets[:, 0], lat.facets[:, 1]
    sel = (hasneg[e1] & cut[e2]) | (cut[e1] & hasneg[e2])
    e1, e2 = e1[sel], e2[sel]
    if e1.numel():
        X1, X2 = X[lat.tets[e1]], X[lat.tets[e2]]
        _, v1, M1 = _geometry(X1)
        _, v2, M2 = _geometry(X2)
        eye = torch.eye(4, dtype=dtype, device=dev).expand(X1.shape[0], 4, 4)
        # slot functions at the corners of T1 and of T2: slots 0-3 the
        # affine extensions of T1's basis, slots 4-7 minus those of T2's
        F1 = torch.cat([eye, -_bary_at(M2, X1).transpose(1, 2)], 1)
        F2 = torch.cat([_bary_at(M1, X2).transpose(1, 2), -eye], 1)

        def mass(Fk, v):
            S = Fk.sum(2)
            return v[:, None, None] / 20.0 * (Fk @ Fk.transpose(1, 2)
                                              + S[:, :, None] * S[:, None, :])

        h2 = (6.0 * v1) ** (2.0 / 3.0)
        Ag = (dt * gamma / h2)[:, None, None] * (mass(F1, v1) + mass(F2, v2))
        sp = torch.cat([lat.tets[e1], lat.tets[e2]], 1)  # (f, 8)
        for a in range(2):
            for b in range(2):
                rows.append((sp + a * nv)[:, :, None].expand(-1, 8, 8)
                            .reshape(-1))
                cols.append((sp + b * nv)[:, None, :].expand(-1, 8, 8)
                            .reshape(-1))
                vals.append((1.0 / 3.0 if a == b else 1.0 / 6.0)
                            * Ag.reshape(-1))

    rhs = torch.zeros(2 * nv, dtype=dtype, device=dev)
    rhs.index_add_(0, st.reshape(-1), Fv.reshape(-1))
    act = torch.zeros(nv, dtype=torch.bool, device=dev)
    act[tets.reshape(-1)] = True
    return System(lat, torch.cat(rows), torch.cat(cols), torch.cat(vals), rhs,
                  hasneg, cut, torch.cat([act, act]))


def solve(S):
    """The solution of the active block (zero elsewhere): the block made
    dense and solved by LU with partial pivoting (``torch.linalg.solve``),
    in the dtype of the system, on its device."""
    act = torch.nonzero(S.active)[:, 0]
    pos = torch.full((S.n,), -1, dtype=torch.int64, device=act.device)
    pos[act] = torch.arange(act.numel(), device=act.device)
    r, c = pos[S.rows], pos[S.cols]
    keep = (r >= 0) & (c >= 0)
    A = torch.zeros(act.numel(), act.numel(), dtype=S.vals.dtype,
                    device=S.vals.device)
    A.index_put_((r[keep], c[keep]), S.vals[keep], accumulate=True)
    x = torch.zeros_like(S.rhs)
    x[act] = torch.linalg.solve(A, S.rhs[act])
    return x
