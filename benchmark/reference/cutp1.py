"""Plain reference of the cut-P1 fictitious-domain Poisson system.

Independent of the program under test: it imports neither ``jax`` nor any
package of this repository, and works out the mesh, the cut geometry, the
operator, the load and the solution again from the benchmark's inputs.

The problem is the reference's ``py_tutorials/fictdom_ghostpen.py`` in 3D on
a box split into Kuhn tetrahedra (every cube cut into the six tetrahedra
that share its diagonal from the lowest to the highest corner), with

- the stiffness over the part of each element where the P1 level set is
  negative (NEG),
- the symmetric Nitsche terms ``-(du/dn) v - (dv/dn) u + lam/h u v`` on the
  planar interface of each cut element, ``n`` the normalised gradient of
  the level set,
- the facet-patch ghost penalty ``gamma/h^2 int_{T1 u T2} (u1 - u2)(v1 -
  v2)`` on the interior facets between an element with a negative part and
  a cut element, ``u1``, ``u2`` the affine extensions of the two
  elements' restrictions,
- the load ``int_NEG f v`` for an affine ``f = a0 + a.x``,

``h = |det J|^(1/3) = (6 |T|)^(1/3)`` as NGSolve's ``specialcf.mesh_size``.
Every integral is exact: the NEG part of a cut element is split into
tetrahedra and its interface into triangles, and products of affine
functions are integrated by the closed vertex formula.  Level-set values
with ``|phi| < 1e-14`` count as ``+1e-14`` for the cut geometry, as in the
reference's straight-cut rule.

All arithmetic runs in the dtype the caller gives, on the device of the
inputs (the card in a benchmark run, the CPU in the tests).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

EPS = 1e-14
# the six Kuhn paths from the lowest to the highest cube corner: each is an
# order of the three axes
_PATHS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


class Lattice:
    """Vertices and Kuhn tetrahedra of the box [lo, hi]^3 with ``nx`` cells
    per axis.  Vertex ``(i, j, k)`` has id ``(i * (nx + 1) + j) * (nx + 1) +
    k``.  ``facets`` holds the interior facets as pairs of element ids."""

    def __init__(self, nx, lo, hi, device, dtype=torch.float64):
        self.nx = nx
        n1 = nx + 1
        self.nv = n1 ** 3
        axis = torch.as_tensor(np.linspace(lo, hi, n1), dtype=torch.float64)
        ii, jj, kk = torch.meshgrid(axis, axis, axis, indexing="ij")
        self.X = torch.stack([ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)],
                             1).to(device=device, dtype=dtype)
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
        self.facets = _interior_facets(self.tets, self.nv)

    def with_dtype(self, dtype):
        """The same lattice with its coordinates in ``dtype``."""
        other = object.__new__(Lattice)
        other.__dict__.update(self.__dict__)
        other.X = self.X.to(dtype)
        return other


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


def guard(phi):
    return torch.where(phi.abs() < EPS, torch.full_like(phi, EPS), phi)


def classify(lat, phi):
    """Element masks of the guarded level set: (has a negative part, cut),
    and the raw mask (a vertex value below 0, no guard)."""
    v = phi[lat.tets]
    g = guard(v)
    hasneg = (g < 0).any(1)
    cut = hasneg & (g > 0).any(1)
    return hasneg, cut, (v < 0).any(1)


def vertices_of(lat, elems):
    """Vertex mask of the elements in the element mask ``elems``."""
    m = torch.zeros(lat.nv, dtype=torch.bool, device=elems.device)
    m[lat.tets[elems].reshape(-1)] = True
    return m


def _geometry(X):
    """Barycentric gradients (E, 4, 3), volumes (E,) and inverse of the
    barycentric map (E, 4, 4) of tetrahedra with vertices X (E, 4, 3)."""
    M = torch.cat([torch.ones_like(X[:, :, :1]), X], 2).transpose(1, 2)
    Minv = torch.linalg.inv(M)
    vol = torch.linalg.det(M).abs() / 6.0
    return Minv[:, :, 1:], vol, Minv


def _bary_at(Minv, P):
    """Barycentric coordinates (E, 4 points, 4) of points P (E, k, 3) in the
    tetrahedra of the inverse maps Minv (E, 4, 4)."""
    Ph = torch.cat([torch.ones_like(P[:, :, :1]), P], 2)
    return torch.einsum("eij,ekj->eki", Minv, Ph)


def _edge_point(g, a, b):
    """Barycentric coordinates (E, 4) of the zero of the level set on the
    edge from corner a to corner b (index tensors (E,))."""
    ga = g.gather(1, a[:, None])[:, 0]
    gb = g.gather(1, b[:, None])[:, 0]
    t = ga / (ga - gb)
    lam = torch.zeros_like(g)
    lam.scatter_(1, a[:, None], (1.0 - t)[:, None])
    lam.scatter_add_(1, b[:, None], t[:, None])
    return lam


def _corner(g, a):
    lam = torch.zeros_like(g)
    lam.scatter_(1, a[:, None], torch.ones_like(g[:, :1]))
    return lam


def _prism(A, B):
    """Three tetrahedra of the convex prism with bottom A and top B (lists of
    three barycentric points, A[i] joined to B[i])."""
    return [(A[0], A[1], A[2], B[2]), (A[0], A[1], B[1], B[2]),
            (A[0], B[0], B[1], B[2])]


def _cut_pieces(g):
    """The cut elements with guarded values g (E, 4) grouped by their number
    of negative corners: for each group, its rows, its NEG tetrahedra and
    its interface triangles as tuples of barycentric points (e, 4)."""
    order = torch.argsort(g, 1)
    m = (g < 0).sum(1)
    out = []
    for k in (1, 2, 3):
        rows = torch.nonzero(m == k)[:, 0]
        if not rows.numel():
            continue
        gk = g[rows]
        o = [order[rows, j] for j in range(4)]
        corner = [_corner(gk, o[j]) for j in range(4)]
        if k == 1:  # one negative corner o0
            p = [_edge_point(gk, o[0], o[j]) for j in (1, 2, 3)]
            tets = [(corner[0], p[0], p[1], p[2])]
            tris = [(p[0], p[1], p[2])]
        elif k == 2:  # negative corners o0, o1
            pac, pad = _edge_point(gk, o[0], o[2]), _edge_point(gk, o[0], o[3])
            pbc, pbd = _edge_point(gk, o[1], o[2]), _edge_point(gk, o[1], o[3])
            tets = _prism([corner[0], pac, pad], [corner[1], pbc, pbd])
            tris = [(pac, pad, pbd), (pac, pbd, pbc)]
        else:  # the element minus the corner at the positive o3
            q = [_edge_point(gk, o[j], o[3]) for j in (0, 1, 2)]
            tets = _prism(corner[:3], q)
            tris = [(q[0], q[1], q[2])]
        out.append((rows, tets, tris))
    return out


def _affine_at(load, P):
    """``a0 + a.x`` at the points P (..., 3)."""
    a0, a = load
    return a0 + P @ torch.as_tensor(a, dtype=P.dtype, device=P.device)


def element_system(lat, phi, lam_c, load):
    """Element matrices (E, 4, 4) and vectors (E, 4) of the volume and
    Nitsche terms on the elements with a negative part, with their ids."""
    hasneg, cut, _ = classify(lat, phi)
    ids = torch.nonzero(hasneg)[:, 0]
    X = lat.X[lat.tets[ids]]
    G, vol, _ = _geometry(X)
    h = (6.0 * vol) ** (1.0 / 3.0)
    GG = G @ G.transpose(1, 2)
    g = guard(phi[lat.tets[ids]])
    iscut = cut[ids]
    fX = _affine_at(load, X)  # (E, 4)
    # uncut elements: the whole element, barycentric points the identity
    wvol = torch.where(iscut, torch.zeros_like(vol), vol)
    fvec = wvol[:, None] / 20.0 * (fX + fX.sum(1, keepdim=True))
    A = wvol[:, None, None] * GG
    c = torch.nonzero(iscut)[:, 0]
    if c.numel():
        Gc, volc = G[c], vol[c]
        wneg = torch.zeros_like(volc)
        fc = torch.zeros_like(Gc[:, :, 0])
        N = torch.zeros_like(GG[c])
        # Nitsche on the interface: n the normalised level-set gradient
        gphi = (phi[lat.tets[ids[c]]][:, :, None] * Gc).sum(1)  # (Ec, 3)
        n = gphi / torch.linalg.vector_norm(gphi, dim=1, keepdim=True)
        dn = (Gc * n[:, None, :]).sum(2)  # (Ec, 4)
        lam = lam_c / h[c]
        for rows, tets, tris in _cut_pieces(g[c]):
            Xr, vr, dnr = X[c][rows], volc[rows], dn[rows]
            for pts in tets:
                Lam = torch.stack(pts, 1)  # (e, 4 points, 4)
                w = torch.linalg.det(Lam).abs() * vr
                wneg[rows] += w
                fk = _affine_at(load, Lam @ Xr)  # (e, 4 points)
                fc[rows] += w[:, None] / 20.0 * (
                    (fk[:, :, None] * Lam).sum(1)
                    + fk.sum(1)[:, None] * Lam.sum(1))
            for pts in tris:
                Lam = torch.stack(pts, 1)  # (e, 3 points, 4)
                P = Lam @ Xr
                area = 0.5 * torch.linalg.vector_norm(
                    torch.linalg.cross(P[:, 1] - P[:, 0], P[:, 2] - P[:, 0]),
                    dim=1)
                S = Lam.sum(1)  # (e, 4)
                I1 = area[:, None] / 3.0 * S
                I2 = area[:, None, None] / 12.0 * (
                    Lam.transpose(1, 2) @ Lam + S[:, :, None] * S[:, None, :])
                N[rows] += (lam[rows][:, None, None] * I2
                            - dnr[:, None, :] * I1[:, :, None]
                            - dnr[:, :, None] * I1[:, None, :])
        A[c] = A[c] + wneg[:, None, None] * GG[c] + N
        fvec[c] = fvec[c] + fc
    return ids, A, fvec


def ghost_penalty(lat, phi, gamma):
    """Element-pair matrices (F, 8, 8) and their dofs (F, 8) of the
    facet-patch ghost penalty on the interior facets between an element
    with a negative part and a cut element."""
    hasneg, cut, _ = classify(lat, phi)
    e1, e2 = lat.facets[:, 0], lat.facets[:, 1]
    sel = (hasneg[e1] & cut[e2]) | (cut[e1] & hasneg[e2])
    e1, e2 = e1[sel], e2[sel]
    X1, X2 = lat.X[lat.tets[e1]], lat.X[lat.tets[e2]]
    _, v1, M1 = _geometry(X1)
    _, v2, M2 = _geometry(X2)
    eye = torch.eye(4, dtype=X1.dtype, device=X1.device).expand(
        X1.shape[0], 4, 4)
    # slot functions at the corners of T1 and of T2: slots 0-3 the affine
    # extensions of T1's basis, slots 4-7 minus those of T2's
    F1 = torch.cat([eye, -_bary_at(M2, X1).transpose(1, 2)], 1)  # (F, 8, 4)
    F2 = torch.cat([_bary_at(M1, X2).transpose(1, 2), -eye], 1)

    def mass(Fk, v):
        S = Fk.sum(2)
        return v[:, None, None] / 20.0 * (Fk @ Fk.transpose(1, 2)
                                          + S[:, :, None] * S[:, None, :])

    h2 = (6.0 * v1) ** (2.0 / 3.0)
    A = (gamma / h2)[:, None, None] * (mass(F1, v1) + mass(F2, v2))
    dofs = torch.cat([lat.tets[e1], lat.tets[e2]], 1)
    return dofs, A


class System:
    """The assembled reference: COO triplets, load, masks."""

    def __init__(self, lat, rows, cols, vals, rhs, hasneg, cut, active):
        self.lat, self.rows, self.cols, self.vals = lat, rows, cols, vals
        self.rhs, self.hasneg, self.cut, self.active = rhs, hasneg, cut, active

    def csr(self):
        """The operator as a CSR tensor, duplicates summed."""
        n = self.lat.nv
        with warnings.catch_warnings():  # sparse CSR support is in beta
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_coo_tensor(torch.stack([self.rows, self.cols]),
                                        self.vals, (n, n)).coalesce()
            return A.to_sparse_csr()

    def matvec(self, x):
        y = torch.zeros(self.lat.nv, dtype=self.vals.dtype, device=x.device)
        return y.index_add_(0, self.rows, self.vals * x[self.cols])


def assemble(lat, phi, lam_c, gamma, load, identity_inactive=False):
    """The reference system of the level-set values ``phi`` (nv,) (their
    dtype is the arithmetic's).  ``identity_inactive`` puts 1 on the
    diagonal of every vertex that no element with a raw negative vertex
    value touches (the lattice model's identity rows); ``active`` is then
    that raw mask, else the vertices of the elements with a negative
    part."""
    ids, Ae, fe = element_system(lat, phi, lam_c, load)
    gdofs, Ag = ghost_penalty(lat, phi, gamma)
    edofs = lat.tets[ids]
    rows = [edofs[:, :, None].expand(-1, 4, 4).reshape(-1),
            gdofs[:, :, None].expand(-1, 8, 8).reshape(-1)]
    cols = [edofs[:, None, :].expand(-1, 4, 4).reshape(-1),
            gdofs[:, None, :].expand(-1, 8, 8).reshape(-1)]
    vals = [Ae.reshape(-1), Ag.reshape(-1)]
    hasneg, cut, rawneg = classify(lat, phi)
    if identity_inactive:
        active = vertices_of(lat, rawneg)
        diag = torch.nonzero(~active)[:, 0]
        rows.append(diag)
        cols.append(diag)
        vals.append(torch.ones_like(diag, dtype=phi.dtype))
    else:
        active = vertices_of(lat, hasneg)
    rhs = torch.zeros(lat.nv, dtype=phi.dtype, device=phi.device)
    rhs.index_add_(0, edofs.reshape(-1), fe.reshape(-1))
    return System(lat, torch.cat(rows), torch.cat(cols), torch.cat(vals), rhs,
                  hasneg, cut, active)


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
