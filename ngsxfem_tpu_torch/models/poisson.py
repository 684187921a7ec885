"""Flagship model: unfitted (fictitious-domain) Poisson on a structured mesh.

PyTorch counterpart of ``ngsxfem_tpu/models/poisson.py`` (the reference's
``py_tutorials/fictdom_ghostpen.py`` workload): level-set geometry, cut-cell
stiffness on the NEG domain, Nitsche terms on the implicit boundary and
facet-patch ghost penalty.  Three routes build the operator:

- the lattice path (``assemble_vals_lattice``) into a DIA table
  ``V (n_off, n)`` in vertex-lexicographic numbering, and the one-pass SoA
  path (``assemble_vals_soa1``) into an ELL value table ``(ndof, K)`` in
  dof numbering (``ell_structure``), both from the closed-form P1 kernels
  ``cut_poisson_flat_soa``/``ghost_penalty_flat_soa``, which work on lists
  of (E,)-shaped tensors as the reference's SoA kernels do;
- the quadrature path: element matrices from cut quadrature rules
  (``cut_poisson_elmats``, ``ghost_penalty_elmats``, any order), applied
  matrix-free by ``apply`` and solved by ``solve``.

Everything runs eagerly on the device of its inputs.  Host index tables stay
numpy; the model holds ``vertices`` and ``lset`` as buffers on its device.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..config import resolve_device
from ..ops.gauss import ET_DIM, reference_rule
from ..ops.scatter import ScatterPlan
from ..fem.basis import ndof_el, lagrange_element, shapes, dshapes
from ..integrate import vertex_local_ids
from ..mesh.mesh import map_points, det_and_inv, small_matmul
from ..ops.straightcut import cut_rule_element, eps_guard, eps_guard_list


def cut_poisson_elmats(et: str, order: int, coords, vals, lam_nitsche=20.0):
    """Element matrices of the fictitious-domain Poisson operator.

    coords (E, nv, d) element vertex coords, vals (E, nv) level-set values.
    Returns (E, nd, nd): NEG-domain stiffness + symmetric Nitsche terms on the
    zero set (the batched analog of SymbolicCutBFI volume+interface assembly,
    reference xfem/symboliccutbfi.cpp:73-276).
    """
    d = ET_DIM[et]
    rule = cut_rule_element(et, vals, 2 * order)

    # NEG volume: grad u . grad v
    _, J = map_points(et, coords, rule.pts)
    detJ, Jinv = det_and_inv(J)
    Gp = small_matmul(dshapes(et, order, rule.pts), Jinv)  # (E,Q,nd,d)
    Wn = rule.w * (rule.side == 0) * detJ.abs()
    A = torch.einsum("eq,eqig,eqjg->eij", Wn, Gp, Gp)

    # interface Nitsche: -dn(u) v - dn(v) u + lam/h u v   (outward normal of NEG)
    _, Ji = map_points(et, coords, rule.pts_if)
    detJi, Jiinv = det_and_inv(Ji)
    nphys = small_matmul(rule.nref[..., None, :], Jiinv)[..., 0, :]
    nn = torch.linalg.vector_norm(nphys, dim=-1, keepdim=True)
    nphys = nphys / torch.where(nn < 1e-30, 1.0, nn)
    Wi = rule.w_if * detJi.abs() * nn[..., 0]
    B = shapes(et, order, rule.pts_if)  # (E,Qi,nd)
    Gip = small_matmul(dshapes(et, order, rule.pts_if), Jiinv)
    dn = (Gip * nphys[:, :, None, :]).sum(-1)  # (E,Qi,nd)
    # mesh size from element volume
    h = detJ[:, :1].abs() ** (1.0 / d)  # (E,1)
    lam = lam_nitsche * order * order / h[:, 0].clamp_min(1e-30)  # (E,)
    # symmetric by construction: the Nitsche cross term is computed once and
    # transposed, and the whole matrix is symmetrized
    C = torch.einsum("eq,eqi,eqj->eij", Wi, dn, B)
    A = A - C - C.transpose(1, 2)
    A = A + torch.einsum("e,eq,eqi,eqj->eij", lam, Wi, B, B)
    return 0.5 * (A + A.transpose(1, 2))


def cut_poisson_rhs_elvecs(et: str, order: int, coords, vals, f_fn):
    """Element load vectors  int_NEG f v  with f_fn(phys_pts)->values."""
    rule = cut_rule_element(et, vals, 2 * order + ET_DIM[et])
    phys, J = map_points(et, coords, rule.pts)
    detJ, _ = det_and_inv(J)
    Wn = rule.w * (rule.side == 0) * detJ.abs()
    B = shapes(et, order, rule.pts)
    return torch.einsum("eq,eq,eqi->ei", Wn, f_fn(phys), B)


def _uncut_rule(et, order, coords):
    """Standard rule of degree `order` on whole elements: (phys (E,Q,d),
    |detJ| weights (E,Q), Jinv, reference points (1,Q,d))."""
    rp, rw = reference_rule(et, order)
    rp = torch.as_tensor(rp, dtype=coords.dtype, device=coords.device)[None]
    rw = torch.as_tensor(rw, dtype=coords.dtype, device=coords.device)
    phys, J = map_points(et, coords, rp)
    detJ, Jinv = det_and_inv(J)
    return phys, (rw * detJ.abs()).expand(phys.shape[:2]), Jinv, rp


def ghost_penalty_elmats(et: str, order: int, coords1, coords2, gamma=0.1):
    """Facet-patch ghost penalty  gamma/h^2 (u-u_other)(v-v_other)  per facet.

    coords1/coords2 (F, nv, d): the two neighbor elements of each marked
    facet.  Returns (F, 2nd, 2nd) on the stacked [self; other] dof axis (the
    batched analog of SymbolicFacetPatchBFI, xfem/symboliccutbfi.cpp:1104-1413;
    neighbor mapping is affine-exact for simplicial meshes).
    """
    d = ET_DIM[et]
    rp, rw = reference_rule(et, 2 * order)
    rp = torch.as_tensor(rp, dtype=coords1.dtype, device=coords1.device)
    rw = torch.as_tensor(rw, dtype=coords1.dtype, device=coords1.device)
    F, nq = coords1.shape[0], rp.shape[0]
    base = rp[None].expand(F, nq, d)

    def into_other(coords_from, coords_to, refpts):
        phys, _ = map_points(et, coords_from, refpts)
        c = torch.full((F, 1, d), 0.25 if et in ("trig", "tet") else 0.5,
                       dtype=coords1.dtype, device=coords1.device)
        cp, Jc = map_points(et, coords_to, c)
        _, Jcinv = det_and_inv(Jc)
        return small_matmul(phys - cp, Jcinv[:, 0].transpose(-1, -2)) + c

    p12 = into_other(coords1, coords2, base)
    p21 = into_other(coords2, coords1, base)

    _, J1 = map_points(et, coords1, base)
    _, J2 = map_points(et, coords2, base)
    det1, _ = det_and_inv(J1)
    det2, _ = det_and_inv(J2)
    w = torch.cat([(det1.abs() * rw).expand(F, nq),
                   (det2.abs() * rw).expand(F, nq)], dim=1)

    B1 = torch.cat([shapes(et, order, base), shapes(et, order, p21)], dim=1)
    B2 = torch.cat([shapes(et, order, p12), shapes(et, order, base)], dim=1)
    Bj = torch.cat([B1, -B2], dim=2)  # (F, 2nq, 2nd): u - u_other

    h = det1[:, :1].abs() ** (1.0 / d)
    scale = gamma / (h[:, 0] ** 2).clamp_min(1e-30)
    out = torch.einsum("f,fq,fqi,fqj->fij", scale, w, Bj, Bj)
    return 0.5 * (out + out.transpose(1, 2))  # exact symmetry


def _soa_corner_arrays(vertices, elements, lset_vertex=None):
    """SoA gathers: per-corner coordinate and level-set (E,) vectors
    (``elements`` is a host (E, nv) table; no level-set list without
    ``lset_vertex``)."""
    nv = elements.shape[1]
    d = vertices.shape[1]
    x, lv = [], []
    for i in range(nv):
        idx = torch.as_tensor(elements[:, i], dtype=torch.int64,
                              device=vertices.device)
        rows = vertices[idx]  # (E, d)
        x.append([rows[:, a] for a in range(d)])
        if lset_vertex is not None:
            lv.append(lset_vertex[idx])
    return x, lv


def _soa_jacobian(x, d):
    """Unrolled affine-simplex Jacobian from SoA corners: returns
    (det (E,), Jinv nested lists [d][g] of (E,))."""
    J = [[x[b + 1][a] - x[0][a] for b in range(d)] for a in range(d)]
    if d == 3:
        c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1]
        c01 = J[0][2] * J[2][1] - J[0][1] * J[2][2]
        c02 = J[0][1] * J[1][2] - J[0][2] * J[1][1]
        c10 = J[1][2] * J[2][0] - J[1][0] * J[2][2]
        c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0]
        c12 = J[0][2] * J[1][0] - J[0][0] * J[1][2]
        c20 = J[1][0] * J[2][1] - J[1][1] * J[2][0]
        c21 = J[0][1] * J[2][0] - J[0][0] * J[2][1]
        c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0]
        det = J[0][0] * c00 + J[0][1] * c10 + J[0][2] * c20
        inv_det = 1.0 / det
        Jinv = [[c00 * inv_det, c01 * inv_det, c02 * inv_det],
                [c10 * inv_det, c11 * inv_det, c12 * inv_det],
                [c20 * inv_det, c21 * inv_det, c22 * inv_det]]
    elif d == 2:
        det = J[0][0] * J[1][1] - J[0][1] * J[1][0]
        inv_det = 1.0 / det
        Jinv = [[J[1][1] * inv_det, -J[0][1] * inv_det],
                [-J[1][0] * inv_det, J[0][0] * inv_det]]
    else:
        det = J[0][0]
        Jinv = [[1.0 / det]]
    return det, Jinv


def _p1_affine_basis(et):
    """Host: P1 basis as an affine map: B_i(p) = b0[i] + Gref[i, :] @ p,
    plus the reference vertex coordinates R (basis-node order)."""
    b = lagrange_element(et, 1)
    exps, C = b["exps"], b["coeff"]
    d = exps.shape[1]
    nv = C.shape[1]
    b0 = np.zeros(nv)
    Gref = np.zeros((nv, d))
    for m in range(exps.shape[0]):
        e = exps[m]
        if e.sum() == 0:
            b0 += C[m]
        elif e.sum() == 1:
            Gref[:, int(np.argmax(e))] += C[m]
    return b0, Gref, b["nodes"]


def ghost_penalty_flat_soa(et, x1, x2, gamma=0.1):
    """SoA closed-form P1 facet-patch ghost penalty.

    For P1 the patch jump (u - u_other) is affine on each of the two patch
    elements, so the penalty integral is exact from vertex values alone:
    int_T f g = V_T / ((d+1)(d+2)) * [sum_k f_k g_k + (sum_k f_k)(sum_k g_k)]
    for affine f, g on a d-simplex (reference SymbolicFacetPatchBFI,
    xfem/symboliccutbfi.cpp:1104-1413).

    x1/x2: nested per-corner coordinate lists [nv][d] of same-shaped tensors
    for the two neighbor elements.  Returns nested A[i][j] ((2nv)^2).
    """
    d = ET_DIM[et]
    nv = d + 1
    b0, Gref, _ = _p1_affine_basis(et)
    det1, Jinv1 = _soa_jacobian(x1, d)
    det2, Jinv2 = _soa_jacobian(x2, d)
    V1 = det1.abs() / float(np.prod(range(1, d + 1)))
    V2 = det2.abs() / float(np.prod(range(1, d + 1)))

    def basis_at(Jinv, x0, pt):
        """All P1 basis values of the element (Jinv, x0) at physical pt."""
        xi = [sum(Jinv[a][g] * (pt[g] - x0[g]) for g in range(d))
              for a in range(d)]
        return [float(b0[i]) + sum(float(Gref[i, a]) * xi[a]
                                   for a in range(d)) for i in range(nv)]

    vperm = vertex_local_ids(et, 1)  # corner k holds Lagrange node vperm[k]
    x0_1 = [x1[0][g] for g in range(d)]
    x0_2 = [x2[0][g] for g in range(d)]
    # f_i values at the patch vertices; vertex columns: [T1 verts; T2 verts]
    # f_i = B1_i (i < nv), f_i = -B2_{i-nv} (i >= nv)   [the (u - u_other)
    # jump with the stacked-dof sign convention of the reference]
    F = [[None] * (2 * nv) for _ in range(2 * nv)]
    for k in range(nv):
        pt1 = [x1[k][g] for g in range(d)]
        pt2 = [x2[k][g] for g in range(d)]
        B2_at_1 = basis_at(Jinv2, x0_2, pt1)
        B1_at_2 = basis_at(Jinv1, x0_1, pt2)
        for i in range(nv):
            F[i][k] = 1.0 if i == int(vperm[k]) else 0.0
            F[i][nv + k] = B1_at_2[i]
            F[nv + i][k] = -B2_at_1[i]
            F[nv + i][nv + k] = -1.0 if i == int(vperm[k]) else 0.0

    c = 1.0 / ((d + 1) * (d + 2))
    h2 = det1.abs() ** (2.0 / d)
    scale = gamma / h2.clamp_min(1e-30)
    w1 = scale * V1 * c
    w2 = scale * V2 * c
    A = [[None] * (2 * nv) for _ in range(2 * nv)]
    for i in range(2 * nv):
        for j in range(i, 2 * nv):
            s1 = None
            s2 = None
            sum_i1 = sum_j1 = sum_i2 = sum_j2 = None
            for k in range(nv):
                t = F[i][k] * F[j][k]
                s1 = t if s1 is None else s1 + t
                t = F[i][nv + k] * F[j][nv + k]
                s2 = t if s2 is None else s2 + t
                sum_i1 = F[i][k] if sum_i1 is None else sum_i1 + F[i][k]
                sum_j1 = F[j][k] if sum_j1 is None else sum_j1 + F[j][k]
                sum_i2 = (F[i][nv + k] if sum_i2 is None
                          else sum_i2 + F[i][nv + k])
                sum_j2 = (F[j][nv + k] if sum_j2 is None
                          else sum_j2 + F[j][nv + k])
            Aij = (w1 * (s1 + sum_i1 * sum_j1)
                   + w2 * (s2 + sum_i2 * sum_j2))
            A[i][j] = Aij
            A[j][i] = Aij
    return A


def cut_poisson_flat_soa(et, lv, det, Jinv, lam_nitsche):
    """One-pass SoA P1 fictitious-domain Poisson element values.

    For P1 on affine simplices every term of the cut operator reduces to
    closed-form scalars per element: basis gradients are element-constant, so
    the NEG-volume stiffness needs only the NEG reference volume; the
    interface is planar, so the Nitsche terms need only degree<=2 interface
    moments (midpoint rule on <=2 reference sub-triangles / 2-pt Gauss on the
    segment), all from the edge cut parameters t = phi_a / (phi_a - phi_b)
    in reference coordinates.  The 2^(d+1) sign patterns are unrolled as
    masked tensor arithmetic over the decomposition tables
    (ops/cuttables._decompose; the cut stiffness/Nitsche forms mirror the
    reference's xfem/symboliccutbfi.cpp:73-276).

    Args: lv list[nv] of eps-guarded (E,) level-set values, det (E,),
    Jinv nested list [d][d] of (E,) (J^{-1}[d, g]).  Returns A as a nested
    list A[i][j] of (E,) tensors (symmetric).
    """
    from ..ops.cuttables import _decompose

    d = ET_DIM[et]
    nv = d + 1
    b0, Gref, R = _p1_affine_basis(et)
    # `lv` arrives in element-corner (REF_VERTS) order; everything below —
    # basis values, gradients, the output dof indices — lives in Lagrange
    # node order, so permute once (corner c sits at node vperm[c])
    vperm = vertex_local_ids(et, 1)
    inv = np.argsort(vperm)
    lv = [lv[int(inv[j])] for j in range(nv)]
    dtype = det.dtype
    zero = torch.zeros_like(det)

    absdet = det.abs()
    # element-constant physical basis gradients Gp[i][g]
    Gp = [[sum(float(Gref[i, a]) * Jinv[a][g] for a in range(d))
           for g in range(d)] for i in range(nv)]
    K = [[sum(Gp[i][g] * Gp[j][g] for g in range(d)) for j in range(nv)]
         for i in range(nv)]
    # reference / physical level-set gradients (element-constant)
    gref = [sum(float(Gref[i, a]) * lv[i] for i in range(nv)) for a in range(d)]
    gphys = [sum(Jinv[a][g] * gref[a] for a in range(d)) for g in range(d)]
    ngref = torch.sqrt(sum(g * g for g in gref))
    ngphys = torch.sqrt(sum(g * g for g in gphys))
    nsafe = ngphys.clamp_min(1e-30)
    nphys = [g / nsafe for g in gphys]          # outward normal of NEG
    dn = [sum(Gp[i][g] * nphys[g] for g in range(d)) for i in range(nv)]
    # physical measure of a unit-ref-area piece of the interface plane
    ifscale = absdet * ngphys / ngref.clamp_min(1e-30)
    h = absdet ** (1.0 / d)
    lam = lam_nitsche / h.clamp_min(1e-30)

    # edge cut parameters (safe everywhere; only used under matching masks)
    def tpar(a, b):
        den = lv[a] - lv[b]
        den = torch.where(den.abs() < 1e-30, 1.0, den)
        return lv[a] / den

    pos = [(v > 0) for v in lv]
    pat = None
    for i in range(nv):
        term = pos[i].to(torch.int32) << i
        pat = term if pat is None else pat | term

    Wvol = zero          # NEG volume in reference coordinates
    m_if = []            # (weight (E,), point coords list[d]) if-quad points

    for p in range(2 ** nv):
        negs = [i for i in range(nv) if not (p >> i) & 1]
        poss = [i for i in range(nv) if (p >> i) & 1]
        if not negs:
            continue
        mask = (pat == p).to(dtype)
        if not poss:
            Wvol = Wvol + mask * (1.0 / math.factorial(d))
            continue
        subs, sides, ifs = _decompose(d, p)
        ts = {}

        def pt(spec):
            a, b = spec
            if a == b:
                return [float(R[a][g]) for g in range(d)]
            if (a, b) not in ts:
                ts[(a, b)] = tpar(a, b)
            t = ts[(a, b)]
            return [float(R[a][g]) + t * (float(R[b][g]) - float(R[a][g]))
                    for g in range(d)]

        for sub, side in zip(subs, sides):
            if side != 0:
                continue
            ps = [pt(s) for s in sub]
            e = [[ps[k + 1][g] - ps[0][g] for g in range(d)]
                 for k in range(d)]
            if d == 3:
                vol = (e[0][0] * (e[1][1] * e[2][2] - e[1][2] * e[2][1])
                       - e[0][1] * (e[1][0] * e[2][2] - e[1][2] * e[2][0])
                       + e[0][2] * (e[1][0] * e[2][1] - e[1][1] * e[2][0]))
                vol = abs(vol) / 6.0
            elif d == 2:
                vol = abs(e[0][0] * e[1][1] - e[0][1] * e[1][0]) / 2.0
            else:
                vol = abs(e[0][0])
            Wvol = Wvol + mask * vol

        for f in ifs:
            ps = [pt(s) for s in f]
            if d == 3:
                u = [ps[1][g] - ps[0][g] for g in range(3)]
                v = [ps[2][g] - ps[0][g] for g in range(3)]
                cx = u[1] * v[2] - u[2] * v[1]
                cy = u[2] * v[0] - u[0] * v[2]
                cz = u[0] * v[1] - u[1] * v[0]
                area = 0.5 * torch.sqrt(cx * cx + cy * cy + cz * cz)
                w = mask * area / 3.0
                # edge-midpoint rule: exact for degree 2
                for (a, b) in ((0, 1), (1, 2), (0, 2)):
                    q = [0.5 * (ps[a][g] + ps[b][g]) for g in range(3)]
                    m_if.append((w, q))
            elif d == 2:
                u = [ps[1][g] - ps[0][g] for g in range(2)]
                ln = torch.sqrt(u[0] * u[0] + u[1] * u[1])
                w = mask * ln / 2.0
                # 2-pt Gauss: exact for degree 3
                c = 0.5 / np.sqrt(3.0)
                for s in (-c, c):
                    q = [0.5 * (ps[0][g] + ps[1][g]) + s * u[g]
                         for g in range(2)]
                    m_if.append((w, q))
            else:
                m_if.append((mask, [ps[0][0]]))

    Wp = Wvol * absdet
    A = [[Wp * K[i][j] if j >= i else None for j in range(nv)]
         for i in range(nv)]

    # Nitsche: -dn_i B_j - dn_j B_i + lam B_i B_j over the interface points
    for (w, q) in m_if:
        wp = w * ifscale
        B = [float(b0[i]) + sum(float(Gref[i, g]) * q[g] for g in range(d))
             for i in range(nv)]
        wl = wp * lam
        for i in range(nv):
            for j in range(i, nv):
                A[i][j] = (A[i][j]
                           - wp * (dn[i] * B[j] + dn[j] * B[i])
                           + wl * B[i] * B[j])
    for i in range(nv):
        for j in range(i):
            A[i][j] = A[j][i]
    return A


def _disp(v, d, nv1):
    """Lattice displacement tuple of a flat vertex-lexicographic offset."""
    out = []
    for ax in range(d):
        out.append(int(v // nv1 ** (d - 1 - ax)))
        v = v % nv1 ** (d - 1 - ax)
    return tuple(out)


class UnfittedPoisson(nn.Module):
    """Fictitious-domain Poisson on a structured simplicial mesh.

    Host-side topology once (numpy); ``vertices`` and ``lset`` are buffers
    on ``device`` (the card unless the caller asks for the CPU).  ``assemble_vals_lattice`` derives the cut weights, the
    ghost-penalty band and the identity rows from the level set it is given,
    so a moved level set needs no rebuild.
    """

    def __init__(self, nx=16, dim=3, order=1, dtype=torch.float32,
                 lam_nitsche=20.0, gamma_gp=0.1, radius=0.4, *, device=None):
        super().__init__()
        from ..mesh.structured import MakeStructured2DMesh, MakeStructured3DMesh
        from ..fem.space import H1

        device = resolve_device(device)
        self.dim, self.order, self.dtype = dim, order, dtype
        self.nx = nx
        self.lam_nitsche, self.gamma_gp = lam_nitsche, gamma_gp
        if dim == 2:
            self.mesh = MakeStructured2DMesh(quads=False, nx=nx, ny=nx)
        else:
            self.mesh = MakeStructured3DMesh(hexes=False, nx=nx, ny=nx, nz=nx)
        self.et = self.mesh.et
        self.space = H1(self.mesh, order=order)
        self.ndof = self.space.ndof
        self.nd = ndof_el(self.et, order)

        # level set: sphere of given radius around the box center
        c = 0.5
        v = self.mesh.vertices_np
        self.lset_np = np.sqrt(((v - c) ** 2).sum(1)) - radius
        self.register_buffer(
            "lset", torch.as_tensor(self.lset_np, dtype=dtype, device=device))

        vperm = vertex_local_ids(self.et, 1)
        p1 = self.space if order == 1 else H1(self.mesh, order=1)
        self.el2vert = p1.el2dof_np[:, vperm]  # (ne, nvel) into vertex-P1 dofs
        self.p1space = p1
        # map P1 dof -> vertex coordinate index (P1 dofs are numbered in
        # fingerprint order, not vertex order)
        self.p1dof2vertex = self._p1_vertex_permutation(p1)
        self.register_buffer(
            "vertices",
            torch.as_tensor(self.mesh.vertices_np, dtype=dtype, device=device))
        # static index tables stay host numpy, as in the reference
        self.el2dof = np.asarray(self.space.el2dof_np)
        self.elements = self.mesh.elements_np

        # ghost-penalty facets: between elements touching the interface band
        vals_el = self.lset_np[self.mesh.elements_np]
        has_neg = (vals_el < 0).any(1)
        has_pos = (vals_el > 0).any(1)
        cut = has_neg & has_pos
        f2e = self.mesh.facet2el_np
        interior = f2e[:, 1] >= 0
        e1 = np.maximum(f2e[:, 0], 0)
        e2 = np.maximum(f2e[:, 1], 0)
        gp = interior & ((cut[e1] & (has_neg[e2])) | (cut[e2] & has_neg[e1]))
        self.gp_facets = np.nonzero(gp)[0]
        self.gp_e1 = f2e[self.gp_facets, 0]
        self.gp_e2 = f2e[self.gp_facets, 1]

        self.active = has_neg  # active element mask (INIT level set)
        ad = np.zeros(self.ndof, dtype=bool)
        ad[self.space.el2dof_np[has_neg].ravel()] = True
        self.active_dofs = ad  # host numpy; INIT level set
        self._gp_sel_np = gp  # frozen ghost-penalty band (all-facet mask)
        self._band_tables = (interior, e1, e2)  # for `_band_guard`
        # device copies of host index tables, made on first use
        self._index_cache = {}

    def load_numpy_state(self, state):
        """Copy ``{"vertices": (nv, d), "lset": (nv,)}`` numpy arrays (e.g.
        the reference package's ``np.asarray(m.vertices)``) into the
        buffers, keeping their dtype and device."""
        for name in ("vertices", "lset"):
            buf = getattr(self, name)
            src = torch.as_tensor(np.array(state[name]))
            if src.shape != buf.shape:
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(buf.shape)}")
            buf.copy_(src)

    def _p1_vertex_permutation(self, p1):
        # P1 dof i sits at vertex dof_rep: match by element/local vertex
        perm = np.zeros(p1.ndof, dtype=np.int64)
        vperm = vertex_local_ids(self.et, 1)
        e2d = p1.el2dof_np[:, vperm]  # (ne, nvel) P1 dof of local vertex
        els = self.mesh.elements_np
        perm[e2d.ravel()] = els.ravel()
        return perm

    def _index(self, arr, device):
        """int64 device copy of a host index table, made once per table and
        device (the table is kept alive beside it, so its id is not reused)."""
        key = (id(arr), str(device))
        hit = self._index_cache.get(key)
        if hit is None or hit[0] is not arr:
            hit = (arr, torch.as_tensor(np.asarray(arr), dtype=torch.int64,
                                        device=device))
            self._index_cache[key] = hit
        return hit[1]

    def active_dof_mask(self, lset_vertex):
        """Runtime active-dof mask from the CURRENT level set (has_neg
        dilated through el2dof), same raw sign convention as ``__init__``."""
        dev = lset_vertex.device
        vals = lset_vertex[self._index(self.elements, dev)]
        has_neg = (vals < 0).any(1).to(torch.int32)
        e2d = self.el2dof
        hits = torch.zeros(self.ndof, dtype=torch.int32, device=dev)
        hits.index_add_(0, self._index(e2d, dev).reshape(-1),
                        has_neg[:, None].expand(e2d.shape).reshape(-1))
        return hits > 0

    def _band_guard(self, lset_vertex, dtype):
        """1.0 while the runtime ghost-penalty band equals the band frozen
        into the structure's gp slots; NaN once the level set moves out of
        it (the lattice path re-marks the band on device and needs no
        guard).  A 0-d tensor: nothing is read back to the host."""
        dev = lset_vertex.device
        vals = lset_vertex[self._index(self.elements, dev)]
        has_neg = (vals < 0).any(1)
        has_pos = (vals > 0).any(1)
        cut = has_neg & has_pos
        interior, e1, e2 = (self._index(t, dev) for t in self._band_tables)
        gpr = (interior.bool()
               & ((cut[e1] & has_neg[e2]) | (cut[e2] & has_neg[e1])))
        ok = (gpr == self._index(self._gp_sel_np, dev).bool()).all()
        return torch.where(ok, torch.tensor(1.0, dtype=dtype, device=dev),
                           torch.tensor(float("nan"), dtype=dtype, device=dev))

    def ell_structure(self):
        """Host precompute of the static global-operator structure: ELL column
        table (ndof, K) plus flat value-slot maps for element matrices
        (ne*nd*nd) and ghost-penalty facet matrices (F*(2nd)^2), in the
        reference's order (``ngsxfem_tpu/models/poisson.py:749``)."""
        from ..mesh.native import unique_i64

        e2d = self.space.el2dof_np
        ne, nd = e2d.shape
        rows_e = np.broadcast_to(e2d[:, :, None], (ne, nd, nd)).reshape(-1)
        cols_e = np.broadcast_to(e2d[:, None, :], (ne, nd, nd)).reshape(-1)
        fdof = np.concatenate([e2d[self.gp_e1], e2d[self.gp_e2]], axis=1)
        F, nd2 = fdof.shape
        rows_f = np.broadcast_to(fdof[:, :, None], (F, nd2, nd2)).reshape(-1)
        cols_f = np.broadcast_to(fdof[:, None, :], (F, nd2, nd2)).reshape(-1)
        rows = np.concatenate([rows_e, rows_f]).astype(np.int64)
        cols = np.concatenate([cols_e, cols_f]).astype(np.int64)
        # diagonal slot of EVERY dof: the identity contribution for inactive
        # dofs is added with a RUNTIME weight (1 - active_dof_mask)
        diag = np.arange(self.ndof, dtype=np.int64)
        rows = np.concatenate([rows, diag])
        cols = np.concatenate([cols, diag])

        n = self.ndof
        lin = rows * n + cols
        uniq, inv = unique_i64(lin)
        nu = len(uniq)
        urows = (uniq // n).astype(np.int64)
        ucols = (uniq % n).astype(np.int32)
        counts = np.bincount(urows, minlength=n)
        K = int(counts.max())
        row_start = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=row_start[1:])
        order = np.argsort(urows, kind="stable")
        pos = np.empty(nu, dtype=np.int64)
        pos[order] = np.arange(nu) - row_start[urows[order]]
        ell_cols = np.zeros((n, K), dtype=np.int32)
        ell_cols[urows, pos] = ucols
        slot_of_uniq = urows * K + pos  # flat slot in the (n, K) value table
        slots = slot_of_uniq[inv]
        ns = len(rows_e)
        # SoA slot order (i, j, e): the element index innermost
        slots_soa = (slots[:ns].reshape(ne, nd, nd)
                     .transpose(1, 2, 0).reshape(-1))
        it = np.int32 if n * K < 2**31 else np.int64
        return {
            "ell_cols": ell_cols,
            "elm_slots": slots[:ns].astype(it),
            "elm_slots_soa": slots_soa.astype(it),
            "gp_slots": slots[ns:ns + len(rows_f)].astype(it),
            # diag_slots[i] = flat slot of (i, i), aligned with dof index
            "diag_slots": slots[ns + len(rows_f):].astype(it),
            "K": K,
        }

    def gp_mats(self, vertices):
        """Ghost-penalty patch matrices (F, 2nd, 2nd) of the frozen band,
        rows and columns in the stacked [e2d[gp_e1]; e2d[gp_e2]] order of
        the gp slots.  Order 1 takes the closed-form
        ``ghost_penalty_flat_soa`` (the reference holds it equal to its
        quadrature ``ghost_penalty_elmats`` to 1e-12,
        tests/test_model_poisson.py:154-171), higher orders the quadrature."""
        if self.order != 1:
            dev = vertices.device
            return ghost_penalty_elmats(
                self.et, self.order,
                vertices[self._index(self.elements[self.gp_e1], dev)],
                vertices[self._index(self.elements[self.gp_e2], dev)],
                self.gamma_gp)
        x1, _ = _soa_corner_arrays(vertices, self.elements[self.gp_e1])
        x2, _ = _soa_corner_arrays(vertices, self.elements[self.gp_e2])
        A = ghost_penalty_flat_soa(self.et, x1, x2, self.gamma_gp)
        n2 = len(A)
        return torch.stack([torch.stack([A[i][j] for j in range(n2)], -1)
                            for i in range(n2)], -2)

    # -- the quadrature path -------------------------------------------------
    def _tiers(self, lset_vertex):
        """(eps-guarded element vertex values, ids of the uncut NEG
        elements, ids of the cut elements), the sets taken exactly."""
        dev = lset_vertex.device
        vals = eps_guard(lset_vertex[self._index(self.elements, dev)])
        has_neg = (vals < 0).any(1)
        has_pos = (vals > 0).any(1)
        return (vals, torch.nonzero(has_neg & ~has_pos)[:, 0],
                torch.nonzero(has_neg & has_pos)[:, 0])

    def elmats(self, vertices, lset_vertex):
        """Element matrices (ne, nd, nd) of the cut operator from quadrature
        rules, in two tiers: the standard rule's stiffness on uncut NEG
        elements, ``cut_poisson_elmats`` on cut ones, zero on POS ones (the
        reference builds the cut rule on every element; the result is the
        same to rounding)."""
        dev = vertices.device
        coords = vertices[self._index(self.elements, dev)]
        vals, neg, cut = self._tiers(lset_vertex)
        A = torch.zeros((self.mesh.ne, self.nd, self.nd), dtype=vertices.dtype,
                        device=dev)
        _, W, Jinv, rp = _uncut_rule(self.et, max(2 * self.order - 2, 0),
                                     coords[neg])
        Gp = small_matmul(dshapes(self.et, self.order, rp), Jinv)
        An = torch.einsum("eq,eqig,eqjg->eij", W, Gp, Gp)
        A[neg] = 0.5 * (An + An.transpose(1, 2))
        A[cut] = cut_poisson_elmats(self.et, self.order, coords[cut],
                                    vals[cut], self.lam_nitsche)
        return A

    def _gp_dofs(self, dev):
        """(F, 2nd) stacked dof map of the ghost-penalty facets."""
        if not hasattr(self, "_gp_dmap"):
            self._gp_dmap = np.concatenate([self.el2dof[self.gp_e1],
                                            self.el2dof[self.gp_e2]], axis=1)
        return self._index(self._gp_dmap, dev)

    def operator(self, vertices, lset_vertex):
        """The matrix-free operator x -> A x of the quadrature path: element
        and ghost-penalty matrices built once, identity rows on the dofs
        inactive under ``lset_vertex``, NaN once the ghost-penalty band of
        ``lset_vertex`` leaves the frozen one (``_band_guard``)."""
        dev = vertices.device
        A = self.elmats(vertices, lset_vertex)
        G = self.gp_mats(vertices)
        e2d = self._index(self.el2dof, dev)
        dmap = self._gp_dofs(dev)
        act = self.active_dof_mask(lset_vertex)
        guard = self._band_guard(lset_vertex, vertices.dtype)

        def matvec(x):
            y = torch.zeros_like(x)
            # (A * x_e).sum(-1), not a batched matvec: on the card that is
            # a library GEMV over 663,552 4x4 blocks at nx=48, 7x slower
            y.index_add_(0, e2d.reshape(-1),
                         (A * x[e2d][:, None, :]).sum(-1).reshape(-1))
            y.index_add_(0, dmap.reshape(-1),
                         (G * x[dmap][:, None, :]).sum(-1).reshape(-1))
            return torch.where(act, y, x) * guard

        return matvec

    def apply(self, vertices, lset_vertex, x):
        """Matrix-free A @ x (assemble-and-apply)."""
        return self.operator(vertices, lset_vertex)(x)

    def rhs(self, vertices, lset_vertex, f_fn):
        """Load vector  int_NEG f v  on the active dofs, in two tiers like
        ``elmats``: the standard rule of degree 2*order + d on uncut NEG
        elements, ``cut_poisson_rhs_elvecs`` on cut ones."""
        dev = vertices.device
        coords = vertices[self._index(self.elements, dev)]
        vals, neg, cut = self._tiers(lset_vertex)
        phys, W, _, rp = _uncut_rule(self.et, 2 * self.order + self.dim,
                                     coords[neg])
        fn = torch.einsum("eq,eq,qi->ei", W, f_fn(phys),
                          shapes(self.et, self.order, rp[0]))
        fc = cut_poisson_rhs_elvecs(self.et, self.order, coords[cut],
                                    vals[cut], f_fn)
        e2d = self._index(self.el2dof, dev)
        b = torch.zeros(self.ndof, dtype=vertices.dtype, device=dev)
        b.index_add_(0, e2d[neg].reshape(-1), fn.reshape(-1))
        b.index_add_(0, e2d[cut].reshape(-1), fc.reshape(-1))
        return torch.where(self.active_dof_mask(lset_vertex), b, 0.0)

    def solve(self, f_fn=None, maxiter=200, tol=1e-8):
        """Assemble the quadrature path and solve with unpreconditioned CG:
        returns (x, iterations, recursion residual norm)."""
        from ..solvers.krylov import cg

        f_fn = f_fn or (lambda p: torch.ones(p.shape[:-1], dtype=p.dtype,
                                             device=p.device))
        b = self.rhs(self.vertices, self.lset, f_fn)
        return cg(self.operator(self.vertices, self.lset), b, maxiter=maxiter,
                  tol=tol)

    def assemble_vals_soa1(self, vertices, lset_vertex, struct):
        """Fully SoA one-pass global assembly (P1 simplices only).

        ``cut_poisson_flat_soa`` computes the values of every element, cut
        or not, as (E,) vectors in one masked-pattern sweep; they are added
        once through ``elm_slots_soa``, then the ghost-penalty patch
        matrices through ``gp_slots`` and the identity rows of inactive dofs
        through ``diag_slots``.  Accepts ELL structures (``ell_structure``,
        value table (ndof, K)) and DIA structures (``dia_structure``, value
        table (n_off, ndof)).  Returns (value table, ncut).

        The three streams are added through one ``ScatterPlan`` of their
        slots, built once per structure and device (``_assembly_plan``):
        each slot sums its contributions in one fixed order, so the table
        is the same on every run, on the CPU and on the card.
        """
        from ..ops.straightcut import eps_guard_list

        et = self.et
        if self.order != 1 or et not in ("trig", "tet"):
            raise NotImplementedError("one-pass SoA assembly is P1-simplex")
        d = ET_DIM[et]
        nv = d + 1
        dev = vertices.device

        x, lv = _soa_corner_arrays(vertices, self.elements, lset_vertex)
        lv = eps_guard_list(lv)
        has_neg = lv[0] < 0
        has_pos = lv[0] > 0
        for v in lv[1:]:
            has_neg = has_neg | (v < 0)
            has_pos = has_pos | (v > 0)
        ncut = (has_neg & has_pos).sum()

        det, Jinv = _soa_jacobian(x, d)
        A = cut_poisson_flat_soa(et, lv, det, Jinv, self.lam_nitsche)
        flat = torch.cat([A[i][j] for i in range(nv) for j in range(nv)])

        if "offsets" in struct:
            out_shape = (len(struct["offsets"]), struct["n"])
        else:
            out_shape = tuple(struct["ell_cols"].shape)
        G = self.gp_mats(vertices)
        idv = 1.0 - self.active_dof_mask(lset_vertex).to(vertices.dtype)
        plan = self._assembly_plan(struct, out_shape[0] * out_shape[1], dev)
        vals = plan.add(torch.cat([flat, G.reshape(-1), idv]))
        vals = vals * self._band_guard(lset_vertex, vertices.dtype)
        return vals.reshape(out_shape), ncut

    def _assembly_plan(self, struct, nslots, device):
        """The ``ScatterPlan`` of the element, ghost-penalty and identity
        slot streams of ``struct`` on ``device``, built at the first call
        and kept beside the structure's slot tables (whose ids key it)."""
        tabs = (struct["elm_slots_soa"], struct["gp_slots"],
                struct["diag_slots"])
        key = ("plan", *map(id, tabs), str(device))
        hit = self._index_cache.get(key)
        if hit is None or any(a is not b for a, b in zip(hit[0], tabs)):
            index = torch.cat([self._index(t, device).reshape(-1)
                               for t in tabs])
            hit = (tabs, ScatterPlan(index, nslots))
            self._index_cache[key] = hit
        return hit[1]

    def dia_structure(self):
        """Host precompute of the offset-diagonal (DIA) global operator in
        vertex-lexicographic numbering.

        On the structured mesh the P1 dof graph is a fixed stencil: every
        (row, col) coupling has col - row in a small constant set (27 offsets
        in 3D including the ghost-penalty second neighbors), so the operator
        is one (n_off, n) diagonal table.  Only valid for order-1 spaces.
        Returns the slot tables, ``offsets``, ``perm`` (dof -> vertex row)
        and ``perm_inv``.
        """
        if self.order != 1:
            raise NotImplementedError("DIA structure requires order=1 "
                                      "(vertex-lexicographic numbering)")
        p = np.asarray(self.p1dof2vertex, dtype=np.int64)  # dof -> vertex row
        n = self.ndof
        e2d = p[self.space.el2dof_np]
        ne, nd = e2d.shape
        rows_e = np.broadcast_to(e2d[:, :, None], (ne, nd, nd))
        cols_e = np.broadcast_to(e2d[:, None, :], (ne, nd, nd))
        fdof = np.concatenate([e2d[self.gp_e1], e2d[self.gp_e2]], axis=1)
        F, nd2 = fdof.shape
        rows_f = np.broadcast_to(fdof[:, :, None], (F, nd2, nd2)).reshape(-1)
        cols_f = np.broadcast_to(fdof[:, None, :], (F, nd2, nd2)).reshape(-1)
        pinv = np.empty(n, dtype=np.int64)
        pinv[p] = np.arange(n)

        off_e = (cols_e - rows_e).reshape(-1)
        off_f = cols_f - rows_f
        # offset DISCOVERY uses ALL interior facets (not just the currently
        # selected ghost-penalty band) so the offset set is topology-only —
        # a moving level set can re-mark the band without changing the
        # operator structure
        f2e = self.mesh.facet2el_np
        ia = f2e[:, 1] >= 0
        fdof_all = np.concatenate([e2d[f2e[ia, 0]], e2d[f2e[ia, 1]]], axis=1)
        ra = np.broadcast_to(fdof_all[:, :, None],
                             fdof_all.shape + (nd2,)).reshape(-1)
        ca = np.broadcast_to(fdof_all[:, None, :],
                             (fdof_all.shape[0], nd2, nd2)).reshape(-1)
        offsets = np.unique(np.concatenate([off_e, off_f, ca - ra, [0]]))
        oidx_e = np.searchsorted(offsets, off_e)
        oidx_f = np.searchsorted(offsets, off_f)
        slots_e = oidx_e * n + rows_e.reshape(-1)
        slots_f = oidx_f * n + rows_f
        idx0 = int(np.searchsorted(offsets, 0))
        slots_i = idx0 * n + p  # diagonal slot of every dof (dof-indexed)
        soa = (slots_e.reshape(ne, nd, nd).transpose(1, 2, 0).reshape(-1))
        gp_soa = (slots_f.reshape(F, nd2, nd2).transpose(1, 2, 0).reshape(-1))
        it = np.int32 if len(offsets) * n < 2**31 else np.int64
        return {
            "offsets": offsets,
            "perm": p,
            "perm_inv": pinv,
            "elm_slots": slots_e.astype(it),
            "elm_slots_soa": soa.astype(it),
            "gp_slots": slots_f.astype(it),
            "gp_slots_soa": gp_soa.astype(it),
            "diag_slots": slots_i.astype(it),
            "n": n,
        }

    def stencil_groups(self, offsets):
        """Host: scatter-free DIA assembly plan for the structured mesh.

        With cubes enumerated in odometer order and S simplices per cube,
        the permuted dof row of corner i of simplex t in cube (a, b, c) is
        a*nv1^2 + b*nv1 + c + D[t, i] with a CONSTANT corner-displacement
        table D (checked).  Every (t, i, j) element-matrix entry therefore
        lands on a fixed diagonal k at a fixed corner displacement, and the
        element-stream assembly is a set of windowed adds on the
        (n_off, nv1, ..)-lattice view of the DIA table.

        Returns (groups, S, nc) where groups maps
        (k, (dz, dy, dx)) -> list of (t, i, j).
        """
        if self.order != 1:
            raise NotImplementedError("stencil assembly requires order=1")
        d = self.dim
        nx = self.nx
        nv1 = nx + 1
        p = np.asarray(self.p1dof2vertex, dtype=np.int64)
        rows = p[self.space.el2dof_np]
        ne, nd = rows.shape
        nc = nx ** d
        S = ne // nc
        if S * nc != ne:
            raise NotImplementedError("mesh is not a full cube lattice")
        rows = rows.reshape(nc, S, nd)
        idx = np.arange(nc)
        base = np.zeros(nc, dtype=np.int64)
        rem = idx
        for ax in range(d):
            q = rem // nx ** (d - 1 - ax)
            rem = rem % nx ** (d - 1 - ax)
            base += q * nv1 ** (d - 1 - ax)
        D = rows - base[:, None, None]
        if not (D == D[0:1]).all():
            raise NotImplementedError("mesh is not lattice-periodic")
        D = D[0]  # (S, nd)

        groups = {}
        for t in range(S):
            for i in range(nd):
                for j in range(nd):
                    o = int(D[t, j] - D[t, i])
                    k = int(np.searchsorted(offsets, o))
                    assert k < len(offsets) and offsets[k] == o
                    key = (k, _disp(int(D[t, i]), d, nv1))
                    groups.setdefault(key, []).append((t, i, j))
        return groups, S, nc

    def gp_lattice_types(self, offsets):
        """Host: lattice plan for the ghost-penalty facet sweep.

        Interior facets of the structured mesh come in a handful of
        lattice-periodic types (12 on 3D tets, 3 on 2D trigs), each covering
        a full rectangular cube-window: facet = (elt (t1, cube c),
        elt (t2, cube c + dc)) for every valid c.  Returns a list of
        (t1, t2, dc, groups) where groups maps (diag k, row disp tuple) ->
        [(i, j)] patch-matrix entries (i, j in the stacked [T1; T2]
        Lagrange-dof order of `ghost_penalty_flat_soa`).
        """
        d = self.dim
        nx = self.nx
        nv1 = nx + 1
        p = np.asarray(self.p1dof2vertex, dtype=np.int64)
        e2d = p[self.space.el2dof_np]
        ne, nd = e2d.shape
        nc = nx ** d
        S = ne // nc
        D = e2d[:S]  # cube-0 rows ARE the displacements (base(0) = 0)
        f2e = self.mesh.facet2el_np
        ia = np.nonzero(f2e[:, 1] >= 0)[0]
        e1, e2 = f2e[ia, 0], f2e[ia, 1]
        c1, t1 = e1 // S, e1 % S
        c2, t2 = e2 // S, e2 % S

        def lat(c):
            out = []
            rem = np.asarray(c)
            for ax in range(d):
                out.append(rem // nx ** (d - 1 - ax))
                rem = rem % nx ** (d - 1 - ax)
            return np.stack(out, -1)

        dc = lat(c2) - lat(c1)
        # count the facets of each (t1, t2, dc) type (vectorized; the
        # reference counts in a Python loop over all interior facets)
        keys_arr = np.concatenate([t1[:, None], t2[:, None], dc], axis=1)
        uniq, counts = np.unique(keys_arr, axis=0, return_counts=True)
        types = []
        for key, count in zip(uniq.tolist(), counts.tolist()):
            ta, tb = key[0], key[1]
            dlt = tuple(key[2:])
            exp = 1
            for dcomp in dlt:
                if dcomp < 0:
                    raise NotImplementedError("negative facet-type offset")
                exp *= nx - abs(dcomp)
            if exp != count:
                raise NotImplementedError("partial facet-type window")
            drow = sum(dlt[ax] * nv1 ** (d - 1 - ax) for ax in range(d))
            pd = [int(D[ta, i]) for i in range(nd)] + \
                 [drow + int(D[tb, i]) for i in range(nd)]

            groups = {}
            for i in range(2 * nd):
                for j in range(2 * nd):
                    o = pd[j] - pd[i]
                    k = int(np.searchsorted(offsets, o))
                    assert k < len(offsets) and offsets[k] == o, o
                    groups.setdefault((k, _disp(pd[i], d, nv1)), []).append((i, j))
            types.append((ta, tb, dlt, groups))
        return types

    def assemble_vals_lattice(self, vertices, lset_vertex, struct):
        """Gather-free lattice assembly of the DIA table.

        After one permutation into vertex-lexicographic order, the corner
        coordinates/level-set values of every element type are plain shifted
        slices of the (nv1, ..) lattice views; the closed-form kernel runs on
        (S, nc) stacked slices, and every element-matrix entry, ghost-penalty
        entry and identity row is a windowed add into the
        (n_off, nv1, ..)-lattice view of the table.  Returns
        (V (n_off, n), ncut).
        """
        et = self.et
        d = ET_DIM[et]
        nv = d + 1
        nx = self.nx
        nv1 = nx + 1
        offsets = struct["offsets"]
        n_off = len(offsets)
        if not hasattr(self, "_stencil_cache"):
            self._stencil_cache = self.stencil_groups(offsets)
        groups, S, nc = self._stencil_cache
        # corner-displacement table in element-corner order (stencil D is in
        # Lagrange dof order; corner c holds node vperm[c])
        p = np.asarray(self.p1dof2vertex, dtype=np.int64)
        D = p[self.space.el2dof_np[:S]].reshape(S, nv)
        vperm = vertex_local_ids(et, 1)

        # `vertices`/`lset_vertex` are indexed by mesh VERTEX id, which on
        # the structured mesh is already lexicographic — the lattice views
        # are plain reshapes, no permutation gather at all
        vlat = vertices.reshape((nv1,) * d + (d,))
        llat = lset_vertex.reshape((nv1,) * d)

        def sl(dsp):
            return tuple(slice(dz, dz + nx) for dz in dsp)

        x = []
        lv = []
        for c in range(nv):
            node = int(vperm[c])
            dsps = [_disp(int(D[t, node]), d, nv1) for t in range(S)]
            x.append([torch.stack([vlat[sl(dsps[t]) + (a,)].reshape(-1)
                                   for t in range(S)]) for a in range(d)])
            lv.append(torch.stack([llat[sl(dsps[t])].reshape(-1)
                                   for t in range(S)]))
        # raw-sign element activity BEFORE the eps guard — the identity-row
        # weights follow the same raw sign convention as __init__
        raw_neg = lv[0] < 0
        for v in lv[1:]:
            raw_neg = raw_neg | (v < 0)
        lv = eps_guard_list(lv)
        has_neg = lv[0] < 0
        has_pos = lv[0] > 0
        for v in lv[1:]:
            has_neg = has_neg | (v < 0)
            has_pos = has_pos | (v > 0)
        ncut = (has_neg & has_pos).sum()

        det, Jinv = _soa_jacobian(x, d)
        A = cut_poisson_flat_soa(et, lv, det, Jinv, self.lam_nitsche)

        # the reference's functional `V.at[idx].add(lat)` becomes an in-place
        # `V[idx] += lat` on a view of the lattice-shaped table
        V = torch.zeros((n_off,) + (nv1,) * d, dtype=vertices.dtype,
                        device=vertices.device)
        for (k, dsp), combos in sorted(groups.items()):
            s = None
            for (t, i, j) in combos:
                term = A[i][j][t]
                s = term if s is None else s + term
            V[(k,) + sl(dsp)] += s.reshape((nx,) * d)

        # ghost penalty: lattice facet-type sweep — corner coords are window
        # slices, the band mask is computed from the current lset, and the
        # contributions are windowed adds (no gathers, no scatters)
        if not hasattr(self, "_gp_lattice_cache"):
            self._gp_lattice_cache = self.gp_lattice_types(offsets)
        cut_e = has_neg & has_pos          # (S, nc)
        cutL = [cut_e[t].reshape((nx,) * d) for t in range(S)]
        negL = [has_neg[t].reshape((nx,) * d) for t in range(S)]

        def cdisp(t, c):
            return _disp(int(D[t, int(vperm[c])]), d, nv1)

        for (ta, tb, dlt, ggroups) in self._gp_lattice_cache:
            win = tuple(nx - dlt[ax] for ax in range(d))

            def wsl(extra):
                return tuple(slice(extra[ax], extra[ax] + win[ax])
                             for ax in range(d))

            x1 = [[vlat[wsl(cdisp(ta, c)) + (a,)] for a in range(d)]
                  for c in range(nv)]
            x2 = [[vlat[wsl(tuple(cdisp(tb, c)[ax] + dlt[ax]
                                  for ax in range(d))) + (a,)]
                   for a in range(d)] for c in range(nv)]
            Agp = ghost_penalty_flat_soa(et, x1, x2, self.gamma_gp)
            w0 = tuple(slice(0, win[ax]) for ax in range(d))
            wd = tuple(slice(dlt[ax], dlt[ax] + win[ax]) for ax in range(d))
            mask = ((cutL[ta][w0] & negL[tb][wd])
                    | (cutL[tb][wd] & negL[ta][w0])).to(vertices.dtype)
            for (k, dsp), ijs in sorted(ggroups.items()):
                s = None
                for (i, j) in ijs:
                    s = Agp[i][j] if s is None else s + Agp[i][j]
                tgt = (k,) + tuple(slice(dsp[ax], dsp[ax] + win[ax])
                                   for ax in range(d))
                V[tgt] += s * mask

        # identity rows for inactive dofs: a vertex dof is active iff some
        # incident element has a negative vertex, i.e. the dilation of the
        # per-type raw has_neg element lattices through the corner
        # displacements (the reference pads and ORs; here each element
        # lattice is OR-ed into its window of one vertex lattice in place)
        act = torch.zeros((nv1,) * d, dtype=torch.bool, device=vertices.device)
        for t in range(S):
            nl = raw_neg[t].reshape((nx,) * d)
            for c in range(nv):
                act[sl(cdisp(t, c))] |= nl
        idx0 = int(np.searchsorted(offsets, 0))
        V[idx0] += 1.0 - act.to(vertices.dtype)
        return V.reshape(n_off, struct["n"]), ncut
