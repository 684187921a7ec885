"""Batched straight-cut quadrature rule construction.

Counterpart of ``ngsxfem_tpu/ops/straightcut.py`` (the reference cut engine,
``cutint/straightcutrule.cpp:580-661`` StraightCutIntegrationRule and the
simplex/box cutters): instead of per-element recursion, all elements are
processed at once by fixed-shape tensor ops on the device of their level-set
values:

  1. epsilon-guard level-set vertex values (ref. straightcutrule.cpp:548-556),
  2. compute a sign-pattern id per (sub-)simplex,
  3. gather the decomposition tables (cuttables.py),
  4. interpolate edge cut points, map reference Gauss rules into every
     sub-simplex, and emit padded quadrature tensors with side tags.

QUAD/HEX elements take the multilinear iterated-integral rule
(ops/multilinear.py).  Every step is differentiable with respect to the
level-set values under ``torch.autograd``.

All weights are *reference-element* weights:
  - volume weights integrate to the sub-domain measure in reference coords;
    multiply by |det J(x)| pointwise for physical integrals,
  - interface weights integrate to the reference (d-1)-measure; multiply by
    ||J^-T n_ref|| * |det J| pointwise (co-area scaling, the batched analog of
    ``TransformQuadUntrafoToIRInterface``, straightcutrule.cpp:558-576).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import as_input, config
from .cuttables import simplex_cut_tables, ET_SPLIT, REF_VERTS, NSUB, NIF
from .gauss import reference_rule, SIMPLEX_OF_DIM, ET_DIM
from ..mesh.mesh import small_matmul


class CutRule(NamedTuple):
    """Padded quadrature tensors for a batch of elements (reference coords).

    Volume part: points `pts` (E,Q,d), weights `w` (E,Q) (zero-padded), side
    tag `side` (E,Q) in {0=NEG,1=POS}.  Interface part: `pts_if` (E,QI,d),
    `w_if` (E,QI), unit reference normal `nref` (E,QI,d) (NEG->POS).
    """

    pts: torch.Tensor
    w: torch.Tensor
    side: torch.Tensor
    pts_if: torch.Tensor
    w_if: torch.Tensor
    nref: torch.Tensor


def eps_guard(vals, eps=None):
    """Snap near-zero level-set values to +eps, exactly like the reference
    (straightcutrule.cpp:553-554, spacetimecutrule.cpp:132: every
    ``|v| < 1e-14`` becomes ``+1e-14`` REGARDLESS of sign), so rounding noise
    cannot fabricate sliver cut elements.  The threshold is ABSOLUTE like the
    reference's; for level sets scaled far from O(1), adjust
    ``config.lset_eps``."""
    if eps is None:
        eps = config.lset_eps
    vals = as_input(vals)
    return torch.where(vals.abs() < eps,
                       torch.tensor(eps, dtype=vals.dtype, device=vals.device),
                       vals)


def eps_guard_list(vals_list, eps=None):
    """``eps_guard`` for SoA corner arrays (one (E,) tensor per corner)."""
    return [eps_guard(v, eps=eps) for v in vals_list]


def _det3(e):
    return (
        e[..., 0, 0] * (e[..., 1, 1] * e[..., 2, 2] - e[..., 1, 2] * e[..., 2, 1])
        - e[..., 0, 1] * (e[..., 1, 0] * e[..., 2, 2] - e[..., 1, 2] * e[..., 2, 0])
        + e[..., 0, 2] * (e[..., 1, 0] * e[..., 2, 1] - e[..., 1, 1] * e[..., 2, 0])
    )


def _gram_measure(edges):
    """k-volume scale factor of a simplex spanned by edge matrix (..., k, g).

    Equals |det| for k==g; sqrt(det(E E^T)) generally. Returns the *scale*
    relative to the unit simplex rule (whose weights already sum to 1/k!).
    """
    k = edges.shape[-2]
    g = edges.shape[-1]
    if k == g:
        if k == 1:
            return edges[..., 0, 0].abs()
        if k == 2:
            return (edges[..., 0, 0] * edges[..., 1, 1]
                    - edges[..., 0, 1] * edges[..., 1, 0]).abs()
        if k == 3:
            return _det3(edges).abs()
    if k == 1:
        det = (edges[..., 0, :] ** 2).sum(-1)
    elif k == 2 and g == 3:
        # |u x v|^2: a sum of squares, where the reference's Gram
        # determinant |u|^2 |v|^2 - (u.v)^2 cancels; for a sliver triangle
        # (area ~1e-14 between O(1) edges) that cancellation leaves ~1e-16
        # of noise, and its square root ~1e-8 of spurious interface measure
        u, v = edges[..., 0, :], edges[..., 1, :]
        det = ((u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1]) ** 2
               + (u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2]) ** 2
               + (u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]) ** 2)
    else:
        det = torch.linalg.det(torch.matmul(edges, edges.transpose(-1, -2)))
    # sqrt'(0) = inf: degenerate (padded) sub-simplices must keep a ZERO
    # gradient, not a NaN one, so guard the argument before the sqrt
    # (d/dphi of masked-out rules is 0 * inf = NaN otherwise)
    pos = det > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, det, 1.0)), 0.0)


def _solve_gradient(edges, dvals):
    """Solve edges @ g = dvals for the P1 gradient on each simplex.

    edges (..., d, d) rows = V_k - V_0; dvals (..., d). Guarded against
    singular (degenerate) simplices: returns zeros there.
    """
    d = edges.shape[-1]
    if d == 1:
        det = edges[..., 0, 0]
        g = dvals[..., 0] / torch.where(det.abs() < 1e-30, 1.0, det)
        return g[..., None]
    if d == 2:
        a, b = edges[..., 0, 0], edges[..., 0, 1]
        c, dd = edges[..., 1, 0], edges[..., 1, 1]
        det = a * dd - b * c
        det = torch.where(det.abs() < 1e-30, 1.0, det)
        g0 = (dvals[..., 0] * dd - dvals[..., 1] * b) / det
        g1 = (dvals[..., 1] * a - dvals[..., 0] * c) / det
        return torch.stack([g0, g1], dim=-1)
    # d == 3: Cramer's rule
    e = edges
    det = _det3(e)
    det = torch.where(det.abs() < 1e-30, 1.0, det)
    cols = []
    for j in range(3):
        mj = torch.cat([e[..., :, :j], dvals[..., :, None], e[..., :, j + 1:]],
                       dim=-1)
        cols.append(_det3(mj) / det)
    return torch.stack(cols, dim=-1)


def _table(arr, device):
    return torch.as_tensor(arr.astype(np.int64), device=device)


def cut_rule_simplices(coords, vals, d: int, order: int):
    """Build cut rules for a batch of d-simplices.

    coords (M, d+1, d): simplex vertex coordinates (in element-reference space),
    vals (M, d+1): level-set values at those vertices (already eps-guarded).
    Returns a CutRule with per-simplex padded tensors.  Numpy ``coords``
    and ``vals`` become tensors on the device of the other argument, else on
    the current card.
    """
    coords = as_input(coords, vals if torch.is_tensor(vals) else None)
    vals = as_input(vals, coords)
    M = coords.shape[0]
    nv = d + 1
    dev, dtype = coords.device, coords.dtype
    tabs = simplex_cut_tables(d)
    vtab = _table(tabs["vtab"], dev)
    stab = _table(tabs["stab"], dev)
    itab = _table(tabs["itab"], dev)
    imask = _table(tabs["imask"], dev)

    rp, rw = reference_rule(SIMPLEX_OF_DIM[d], order)
    rp = torch.as_tensor(rp, dtype=dtype, device=dev)  # (nq, d)
    rw = torch.as_tensor(rw, dtype=dtype, device=dev)  # (nq,)
    if d - 1 >= 1:
        ip, iw = reference_rule(SIMPLEX_OF_DIM[d - 1], order)
    else:  # point rule for 1D interfaces
        ip, iw = np.zeros((1, 0)), np.ones((1,))
    ip = torch.as_tensor(ip, dtype=dtype, device=dev)  # (nqi, d-1)
    iw = torch.as_tensor(iw, dtype=dtype, device=dev)

    nq, nqi = rw.shape[0], iw.shape[0]
    nsub, nif = NSUB[d], NIF[d]

    # 1. sign pattern per simplex
    powers = torch.tensor([1 << i for i in range(nv)], device=dev)
    pattern = ((vals > 0).to(torch.int64) * powers).sum(-1)  # (M,)

    # 2. all candidate points: P[a,b] = cut point of edge (a,b); P[a,a] = V_a
    #    t = phi_a / (phi_a - phi_b), guarded
    den = vals[:, :, None] - vals[:, None, :]  # (M, nv, nv)
    den = torch.where(den.abs() < 1e-30, 1.0, den)
    t = (vals[:, :, None] / den).clamp(0.0, 1.0)  # (M, nv, nv)
    P = ((1.0 - t[..., None]) * coords[:, :, None, :]
         + t[..., None] * coords[:, None, :, :])
    eye = torch.eye(nv, dtype=dtype, device=dev)[None, :, :, None]
    P = P * (1 - eye) + coords[:, :, None, :] * eye  # ensure exact diag
    Pflat = P.reshape(M, nv * nv, d)

    # 3. gather decomposition
    vt = vtab[pattern]  # (M, nsub, nv, 2)
    vidx = vt[..., 0] * nv + vt[..., 1]  # (M, nsub, nv)
    rows = torch.arange(M, device=dev)[:, None, None]
    sub = Pflat[rows, vidx]  # (M, nsub, nv, d)
    side = stab[pattern]  # (M, nsub)

    # 4. volume rule on each sub-simplex
    v0 = sub[:, :, 0:1, :]  # (M,nsub,1,d)
    E = sub[:, :, 1:, :] - v0  # (M,nsub,d,d)
    scale = _gram_measure(E)  # (M,nsub)
    pts = v0 + small_matmul(rp, E)  # (M,nsub,nq,d)
    w = scale[:, :, None] * rw  # (M,nsub,nq)

    # snap padded/degenerate points to the simplex centroid so downstream
    # coefficient evaluation never sees duplicated corner points (guards
    # against 0 * singular-value = NaN)
    centroid = coords.mean(dim=1)  # (M,d)
    good = w > 0
    pts = torch.where(good[..., None], pts, centroid[:, None, None, :])

    pts = pts.reshape(M, nsub * nq, d)
    w = w.reshape(M, nsub * nq)
    sidep = side[:, :, None].expand(M, nsub, nq).reshape(M, nsub * nq)

    # 5. interface rule
    it = itab[pattern]  # (M, nif, d, 2)
    iidx = it[..., 0] * nv + it[..., 1]  # (M, nif, d)
    isub = Pflat[rows, iidx]  # (M, nif, d, d)
    imk = imask[pattern].to(dtype)  # (M, nif)
    iv0 = isub[:, :, 0:1, :]
    iE = isub[:, :, 1:, :] - iv0  # (M,nif,d-1,d)
    if d > 1:
        iscale = _gram_measure(iE)
        pts_if = iv0 + small_matmul(ip, iE)
    else:
        iscale = torch.ones_like(imk)
        pts_if = iv0.expand(M, nif, nqi, d)
    w_if = (iscale * imk)[:, :, None] * iw
    goodi = w_if > 0
    pts_if = torch.where(goodi[..., None], pts_if, centroid[:, None, None, :])
    pts_if = pts_if.reshape(M, nif * nqi, d)
    w_if = w_if.reshape(M, nif * nqi)

    # 6. reference normal from the P1 gradient on the simplex (NEG -> POS)
    Eel = coords[:, 1:, :] - coords[:, 0:1, :]  # (M,d,d)
    dv = vals[:, 1:] - vals[:, 0:1]  # (M,d)
    g = _solve_gradient(Eel, dv)  # (M,d)
    gn = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    nref = g / torch.where(gn < 1e-30, 1.0, gn)
    nref = nref[:, None, :].expand(M, nif * nqi, d)

    return CutRule(pts, w, sidep, pts_if, w_if, nref)


def simplex_split_rule(et: str, vals, order: int):
    """Cut rule of elements of type `et` split into the simplices of
    ``ET_SPLIT[et]``: vals (E, nvel) eps-guarded -> CutRule (E, ...)."""
    d = ET_DIM[et]
    E = vals.shape[0]
    split = torch.as_tensor(ET_SPLIT[et].astype(np.int64), device=vals.device)
    nsplit = split.shape[0]
    refv = torch.as_tensor(REF_VERTS[et], dtype=vals.dtype, device=vals.device)
    coords = refv[split][None].expand(E, nsplit, d + 1, d).reshape(
        E * nsplit, d + 1, d)
    svals = vals[:, split].reshape(E * nsplit, d + 1)
    r = cut_rule_simplices(coords, svals, d, order)
    return CutRule(*(a.reshape(E, nsplit * a.shape[1], *a.shape[2:])
                     for a in r))


def cut_rule_element(et: str, elem_vals, order: int, policy: str = "OPTIMAL",
                     *, device=None):
    """Cut rule for a batch of elements of type `et` in *element-reference*
    coordinates (the exported ``CreateCutIntegrationRule``).

    elem_vals (E, nvel): level-set values at element vertices, a tensor, or
    a numpy array that becomes one on ``device`` (the card unless the caller
    asks for the CPU; ``config.dtype`` unless it is a floating array).
    QUAD/HEX get the genuine multilinear iterated-integral rule
    (ops/multilinear.py) under `policy` in {"FIRST", "OPTIMAL", "FALLBACK"}
    (reference SWAP_DIMENSIONS_POLICY); simplices ignore the policy.
    """
    if not torch.is_tensor(elem_vals):
        host = np.asarray(elem_vals)
        elem_vals = as_input(host, device=device, dtype=(
            None if host.dtype.kind == "f" else config.dtype))
    vals = eps_guard(elem_vals)
    if et in ("quad", "hex"):
        from .multilinear import quad_cut_rule, hex_cut_rule

        fn = quad_cut_rule if et == "quad" else hex_cut_rule
        return fn(vals, order, policy)
    return simplex_split_rule(et, vals, order)
