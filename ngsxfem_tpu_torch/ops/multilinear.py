"""Multilinear (QUAD/HEX) straight-cut quadrature: iterated-integral rules.

Counterpart of ``ngsxfem_tpu/ops/multilinear.py``, a batched redesign of
the reference tensor-product cutter
(``cutint/straightcutrule.cpp:206-501`` LevelsetCutQuadrilateral): the level
set on a QUAD/HEX is the genuine multilinear interpolant of the vertex values
(``straightcutrule.cpp:503-526`` GetCoeffsFromVals), NOT a piecewise-linear
surrogate.  The rule is an iterated integral: 1D Gauss along an outer axis x
a recursive codim-1 cut rule on each slice, with

  * topology-change splits of the outer axis at the sign-change roots of the
    outer-direction edges (``:206-252`` HasTopologyChangeAlongXi/Decompose),
  * axis choice by the exact 2D criterion (``:386-407``) or the sufficient 3D
    bound (``:353-384``) under policy FIRST/OPTIMAL/FALLBACK
    (``:409-457`` GetDimensionSwap, c = 0.999),
  * interface weights scaled by the co-area factor ||grad phi|| / ||grad_perp||
    (``:283-298``), and
  * a simplex-split fallback when no axis is admissible (``:475-491``).

What makes this a *fixed-shape* batched program: a multilinear level set has
at most 2 (2D) / 4 (3D) outer-edge roots, so the outer axis splits into at
most 3 / 5 intervals; each 1D slice cut yields at most 2 subsegments and 1
interface point.  The whole recursion therefore unrolls into dense masked
tensors - no control flow, no recursion.
Elements routed to a different axis are handled by *value permutation into a
canonical orientation* (one gather) and a coordinate swap of the output
points, not by separate branches.

Weight conventions match ops/straightcut.py: volume weights integrate to the
reference-element subdomain measure; interface weights integrate to the
reference (d-1)-measure with the multilinear normal, so the physical scaling
||J^-T n|| * |det J| applies unchanged.  `nref` is the normalized multilinear
gradient at each interface point (pointwise - the reference evaluates
``LevelsetWrapper::GetNormal`` per point in TransformQuadUntrafoToIRInterface,
``straightcutrule.cpp:558-576``).
"""
from __future__ import annotations

import numpy as np
import torch

from .cuttables import REF_VERTS
from .gauss import gauss_legendre_01, _n_for_degree
from ..mesh.mesh import multilinear_grad

# graph-slope admissibility bound (reference straightcutrule.cpp:253-254)
C_SAFE = 0.999

# vertex-value permutations realizing coordinate swaps on the reference
# QUAD [(0,0),(1,0),(1,1),(0,1)] and HEX [(0,0,0),(1,0,0),(1,1,0),(0,1,0),
# (0,0,1),(1,0,1),(1,1,1),(0,1,1)] orderings: entry i = vertex whose swapped
# coordinates equal vertex i's coordinates.
QUAD_SWAP_XY = np.array([0, 3, 2, 1], dtype=np.int64)
HEX_SWAP_YZ = np.array([0, 1, 5, 4, 3, 2, 6, 7], dtype=np.int64)
HEX_SWAP_XZ = np.array([0, 4, 7, 3, 1, 5, 6, 2], dtype=np.int64)

_TINY = 1e-30


def _const(a, like):
    """Host constant as a tensor of `like`'s dtype and device."""
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _idx(a, like):
    return torch.as_tensor(a, dtype=torch.int64, device=like.device)


def _coeffs_quad(v):
    """Bilinear coefficients (c00, c10, c01, c11) from corner values (B, 4)."""
    v0, v1, v2, v3 = v[:, 0], v[:, 1], v[:, 2], v[:, 3]
    return v0, v1 - v0, v3 - v0, v2 - v1 - v3 + v0


def _edge_root(a, b):
    """Sign-change parameter on an edge: t with (1-t)a + t b = 0, else 1."""
    cut = (a > 0) != (b > 0)
    den = a - b
    den = torch.where(den.abs() < _TINY, 1.0, den)
    return torch.where(cut, (a / den).clamp(0.0, 1.0), 1.0)


def _fallback_parts(et: str, vals, order: int):
    """Simplex-split rule for quad/hex (the role of the reference's
    GetFallbackIntegrationRule, straightcutrule.cpp:475-491): returns
    (pts, w, side, pts_if, w_if).

    For QUAD the split is the *center fan* {corner_i, corner_{i+1}, center}
    (4 triangles) rather than the reference's fixed diagonal: the bilinear's
    center value equals the corner mean, so the fan needs no extra evaluation,
    resolves TPMC-ambiguous (saddle) sign patterns correctly, and avoids the
    pathological case of a diagonal anchored at the lone cut corner (where the
    bilinear restricted to the diagonal is strongly quadratic and the P1
    surrogate misplaces the interface).  HEX keeps the 6-tet Kuhn split.
    """
    from .straightcut import cut_rule_simplices, simplex_split_rule

    if et != "quad":
        r = simplex_split_rule(et, vals, order)
        return r.pts, r.w, r.side, r.pts_if, r.w_if
    B = vals.shape[0]
    corners = _const(REF_VERTS["quad"], vals)  # (4,2)
    center = torch.full((1, 2), 0.5, dtype=vals.dtype, device=vals.device)
    pts5 = torch.cat([corners, center], dim=0)  # (5,2)
    fan = _idx(np.array([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]]), vals)
    vmean = vals.mean(dim=1, keepdim=True)  # = bilinear at center
    vals5 = torch.cat([vals, vmean], dim=1)  # (B,5)
    nsplit = 4
    coords = pts5[fan][None].expand(B, nsplit, 3, 2).reshape(B * nsplit, 3, 2)
    svals = vals5[:, fan].reshape(B * nsplit, 3)
    r = cut_rule_simplices(coords, svals, 2, order)
    merge = lambda a: a.reshape(B, nsplit * a.shape[1], *a.shape[2:])
    return merge(r.pts), merge(r.w), merge(r.side), merge(r.pts_if), merge(r.w_if)


# --------------------------------------------------------------------------
# 2D: bilinear quad
# --------------------------------------------------------------------------

def _quad_axis_choice(vals, policy: str):
    """Per-element DIMENSION_SWAP by the exact 2D criterion
    (reference GetExactCritsQBound2D + GetDimensionSwap,
    straightcutrule.cpp:386-457): 0 = ID (outer y, interface an x-graph),
    1 = swap x<->y, 2 = NONE (simplex fallback)."""
    _, c10, c01, c11 = _coeffs_quad(vals)
    den = torch.where(c11.abs() < _TINY, _TINY, c11)
    # a root of d_x phi (resp. d_y phi) inside the box kills that inner axis
    root_dx = -c10 / den  # d_x phi(y) = c10 + c11*y = 0
    root_dy = -c01 / den  # d_y phi(x) = c01 + c11*x = 0
    nontriv = c11.abs() >= _TINY
    dis_id = nontriv & (root_dx > 0) & (root_dx < 1)
    dis_xy = nontriv & (root_dy > 0) & (root_dy < 1)
    # corner gradient direction bounds
    xc = _const([0.0, 1.0, 1.0, 0.0], vals)
    yc = _const([0.0, 0.0, 1.0, 1.0], vals)
    gx = c10[:, None] + c11[:, None] * yc[None, :]  # (B,4)
    gy = c01[:, None] + c11[:, None] * xc[None, :]
    gn = torch.sqrt(gx**2 + gy**2).clamp_min(_TINY)
    bound_id = (gy.abs() / gn).amax(dim=1)  # outer y needs |d_x| dominant
    bound_xy = (gx.abs() / gn).amax(dim=1)
    bound_id = torch.where(dis_id, 2.0, bound_id)
    bound_xy = torch.where(dis_xy, 2.0, bound_xy)
    ok_id, ok_xy = bound_id < C_SAFE, bound_xy < C_SAFE
    if policy == "FIRST":
        sw = torch.where(ok_id, 0, torch.where(ok_xy, 1, 2))
    else:  # OPTIMAL
        pick = torch.where(bound_id <= bound_xy, 0, 1)
        sw = torch.where(ok_id & ok_xy, pick,
                         torch.where(ok_id, 0, torch.where(ok_xy, 1, 2)))
    return sw


def _quad_tensor_canonical(vals, order: int):
    """Iterated-integral rule on the unit quad, outer axis y, inner axis x.

    vals (B, 4) bilinear corner values.  Returns
      pts (B, 6G^2, 2), w (B, 6G^2), side (B, 6G^2) in {0,1},
      pts_if (B, 3G, 2), w_if (B, 3G)  [arclength measure, includes the
      ||grad2|| / |d_x phi| graph factor].
    """
    G = _n_for_degree(order)
    tg, wg = gauss_legendre_01(G)
    tg = _const(tg, vals)
    wg = _const(wg, vals)
    B = vals.shape[0]
    v0, v1, v2, v3 = vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3]

    # outer-axis breakpoints: roots on the x=0 edge (v0->v3) and x=1 edge
    # (v1->v2); uncut edges contribute a collapsed breakpoint at 1.
    r0 = _edge_root(v0, v3)
    r1 = _edge_root(v1, v2)
    zero = torch.zeros_like(r0)
    one = torch.ones_like(r0)
    b = torch.sort(torch.stack([zero, r0, r1, one], dim=-1), dim=-1).values
    lo, dy = b[:, :3], b[:, 1:] - b[:, :3]  # (B,3)
    y = lo[:, :, None] + dy[:, :, None] * tg  # (B,3,G)
    wy = dy[:, :, None] * wg

    # slice endpoint values phi(0,y), phi(1,y) - signs constant per interval
    p0 = v0[:, None, None] * (1 - y) + v3[:, None, None] * y
    p1 = v1[:, None, None] * (1 - y) + v2[:, None, None] * y
    s0, s1 = p0 > 0, p1 > 0
    cutm = s0 != s1
    den = p0 - p1
    den = torch.where(den.abs() < _TINY, 1.0, den)
    t = torch.where(cutm, (p0 / den).clamp(0.0, 1.0),
                    torch.where(s0, 0.0, 1.0))  # (B,3,G)
    # uncut-neg slices get t=1 (segment A covers the slice), uncut-pos t=0.

    # volume: segment A = [0,t] side sign(p0), segment B = [t,1] side sign(p1)
    xA = t[..., None] * tg  # (B,3,G,G)
    wA = wy[..., None] * wg * t[..., None]
    xB = t[..., None] + (1.0 - t[..., None]) * tg
    wB = wy[..., None] * wg * (1.0 - t[..., None])
    x = torch.stack([xA, xB], dim=3)  # (B,3,G,2,G)
    wv = torch.stack([wA, wB], dim=3)
    side = torch.stack([s0, s1], dim=3).to(torch.int64)  # (B,3,G,2)
    side = side[..., None].expand(x.shape)
    yb = y[:, :, :, None, None].expand(x.shape)
    # explicit sizes: reshape(B, -1) is ambiguous for an empty batch
    nvol = int(np.prod(x.shape[1:]))
    pts = torch.stack([x, yb], dim=-1).reshape(B, nvol, 2)
    w = wv.reshape(B, nvol)
    side = side.reshape(B, nvol)

    # interface: the graph point (t, y) with the co-area factor
    # ||grad2 phi|| / |d_x phi| (reference straightcutrule.cpp:283-298)
    _, c10, c01, c11 = _coeffs_quad(vals)
    gx = c10[:, None, None] + c11[:, None, None] * y
    gy = c01[:, None, None] + c11[:, None, None] * t
    g2 = torch.sqrt(gx**2 + gy**2)
    scale = g2 / gx.abs().clamp_min(_TINY)
    w_if = torch.where(cutm, wy * scale, 0.0)
    nif = int(np.prod(t.shape[1:]))
    pts_if = torch.stack([t, y], dim=-1).reshape(B, nif, 2)
    w_if = w_if.reshape(B, nif)
    return pts, w, side, pts_if, w_if


def _quad_rule_parts(vals, order: int, policy: str):
    """Full 2D multilinear rule (tensor + fallback capacities, masked).

    vals (B, 4) eps-guarded corner values.  Returns (pts, w, side, pts_if,
    w_if); `nref` is left to the caller (top-level 2D vs 3D-slice use differ).
    """
    B = vals.shape[0]
    if policy == "FALLBACK":
        sw = torch.full((B,), 2, dtype=torch.int64, device=vals.device)
    else:
        sw = _quad_axis_choice(vals, policy)
    vals_c = torch.where((sw == 1)[:, None], vals[:, _idx(QUAD_SWAP_XY, vals)],
                         vals)
    pts, w, side, pts_if, w_if = _quad_tensor_canonical(vals_c, order)
    # swap output coordinates back for X_Y elements; mask NONE elements
    swapped = (sw == 1)[:, None, None]
    pts = torch.where(swapped, pts.flip(-1), pts)
    pts_if = torch.where(swapped, pts_if.flip(-1), pts_if)
    use_tensor = (sw != 2)[:, None]
    w = torch.where(use_tensor, w, 0.0)
    w_if = torch.where(use_tensor, w_if, 0.0)

    fpts, fw, fside, fpts_if, fw_if = _fallback_parts("quad", vals, order)
    fb = (sw == 2)[:, None]
    fw = torch.where(fb, fw, 0.0)
    fw_if = torch.where(fb, fw_if, 0.0)

    return (
        torch.cat([pts, fpts], dim=1),
        torch.cat([w, fw], dim=1),
        torch.cat([side, fside], dim=1),
        torch.cat([pts_if, fpts_if], dim=1),
        torch.cat([w_if, fw_if], dim=1),
    )


def quad_cut_rule(vals, order: int, policy: str = "OPTIMAL"):
    """Multilinear cut rule on the unit QUAD. vals (B,4) eps-guarded.
    Returns a CutRule (imported lazily to avoid a circular import)."""
    from .straightcut import CutRule

    pts, w, side, pts_if, w_if = _quad_rule_parts(vals, order, policy)
    g = multilinear_grad("quad", vals, pts_if)
    gn = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    nref = g / gn.clamp_min(_TINY)
    return CutRule(pts, w, side, pts_if, w_if, nref)


# --------------------------------------------------------------------------
# 3D: trilinear hex
# --------------------------------------------------------------------------

def _hex_axis_choice(vals, policy: str):
    """Per-element swap by the sufficient 3D criterion (reference
    GetSufficientCritsQBound + GetDimensionSwap, straightcutrule.cpp:353-457):
    0 = ID (outer z), 1 = swap y<->z, 2 = swap x<->z, 3 = NONE."""
    corners = _const(REF_VERTS["hex"], vals)  # (8,3)
    g = multilinear_grad("hex", vals, corners[None])
    g2 = g**2  # (B,8,3)
    Vsq = g2.amax(dim=1).sum(dim=-1)  # (B,)
    den = (Vsq[:, None, None] - g2).clamp_min(_TINY)
    q_est = (Vsq[:, None, None] / den).amax(dim=1)  # (B,3)
    bound = torch.sqrt((1.0 - 1.0 / q_est.clamp_min(1.0)).clamp(0.0, 1.0))
    bx, by, bz = bound[:, 0], bound[:, 1], bound[:, 2]
    if policy == "FIRST":
        sw = torch.where(bz < C_SAFE, 0,
                         torch.where(by < C_SAFE, 1,
                                     torch.where(bx < C_SAFE, 2, 3)))
    else:  # OPTIMAL: smallest bound wins if admissible
        min_val, min_dim = bound.min(dim=1)  # 0=x,1=y,2=z
        sw_of_dim = _idx([2, 1, 0], vals)  # x->XZ, y->YZ, z->ID
        sw = torch.where(min_val < C_SAFE, sw_of_dim[min_dim], 3)
    return sw


def hex_cut_rule(vals, order: int, policy: str = "OPTIMAL"):
    """Multilinear cut rule on the unit HEX. vals (B,8) eps-guarded.

    Outer-z iterated integral: topology breakpoints from the four z-edge
    roots (5 intervals), Gauss nodes per interval, and the full 2D quad rule
    (with its own axis choice and fallback) on each bilinear slice.  Interface
    weights compose the slice arclength measure with the co-area lift
    ||grad3|| / ||grad_xy|| (reference straightcutrule.cpp:283-298).
    """
    from .straightcut import CutRule

    B = vals.shape[0]
    G = _n_for_degree(order)
    tg, wg = gauss_legendre_01(G)
    tg = _const(tg, vals)
    wg = _const(wg, vals)

    if policy == "FALLBACK":
        sw = torch.full((B,), 3, dtype=torch.int64, device=vals.device)
    else:
        sw = _hex_axis_choice(vals, policy)
    vals_yz = vals[:, _idx(HEX_SWAP_YZ, vals)]
    vals_xz = vals[:, _idx(HEX_SWAP_XZ, vals)]
    vals_c = torch.where((sw == 1)[:, None], vals_yz,
                         torch.where((sw == 2)[:, None], vals_xz, vals))

    # outer-z breakpoints: roots on the 4 z-direction edges (i, i+4)
    roots = [_edge_root(vals_c[:, i], vals_c[:, i + 4]) for i in range(4)]
    zero = torch.zeros_like(roots[0])
    one = torch.ones_like(roots[0])
    b = torch.sort(torch.stack([zero] + roots + [one], dim=-1), dim=-1).values
    lo, dz = b[:, :5], b[:, 1:] - b[:, :5]  # (B,5)
    z = lo[:, :, None] + dz[:, :, None] * tg  # (B,5,G)
    wz = dz[:, :, None] * wg

    # bilinear slice corner values at each z node
    bot = vals_c[:, :4]  # (B,4)
    top = vals_c[:, 4:]
    f = ((1.0 - z)[..., None] * bot[:, None, None, :]
         + z[..., None] * top[:, None, None, :])  # (B,5,G,4)
    S = B * 5 * G
    slice_vals = f.reshape(S, 4)
    pts2, w2, side2, pts_if2, w_if2 = _quad_rule_parts(slice_vals, order, policy)
    Q2, Qi2 = pts2.shape[1], pts_if2.shape[1]

    # embed volume points: (x, y, z*), weight * wz
    zq = z.reshape(S, 1).expand(S, Q2)
    pts3 = torch.cat([pts2, zq[..., None]], dim=-1)  # (S,Q2,3)
    w3 = w2 * wz.reshape(S, 1)
    pts3 = pts3.reshape(B, 5 * G * Q2, 3)
    w3 = w3.reshape(B, 5 * G * Q2)
    side3 = side2.reshape(B, 5 * G * Q2)

    # embed interface points with the co-area lift in canonical coords
    zqi = z.reshape(S, 1).expand(S, Qi2)
    pts_if3 = torch.cat([pts_if2, zqi[..., None]], dim=-1)  # (S,Qi2,3)
    g3 = multilinear_grad("hex", torch.repeat_interleave(vals_c, 5 * G, dim=0),
                          pts_if3)  # (S,Qi2,3) canonical trilinear gradient
    gxy = torch.linalg.vector_norm(g3[..., :2], dim=-1)
    gall = torch.linalg.vector_norm(g3, dim=-1)
    lift = gall / gxy.clamp_min(_TINY)
    w_if3 = w_if2 * wz.reshape(S, 1) * lift
    pts_if3 = pts_if3.reshape(B, 5 * G * Qi2, 3)
    w_if3 = w_if3.reshape(B, 5 * G * Qi2)

    # un-permute output coordinates; mask NONE elements
    def unswap(p):
        p_yz = p[..., _idx([0, 2, 1], vals)]
        p_xz = p[..., _idx([2, 1, 0], vals)]
        return torch.where((sw == 1)[:, None, None], p_yz,
                           torch.where((sw == 2)[:, None, None], p_xz, p))

    pts3 = unswap(pts3)
    pts_if3 = unswap(pts_if3)
    use_tensor = (sw != 3)[:, None]
    w3 = torch.where(use_tensor, w3, 0.0)
    w_if3 = torch.where(use_tensor, w_if3, 0.0)

    fpts, fw, fside, fpts_if, fw_if = _fallback_parts("hex", vals, order)
    fb = (sw == 3)[:, None]
    fw = torch.where(fb, fw, 0.0)
    fw_if = torch.where(fb, fw_if, 0.0)

    pts = torch.cat([pts3, fpts], dim=1)
    w = torch.cat([w3, fw], dim=1)
    side = torch.cat([side3, fside], dim=1)
    pts_if = torch.cat([pts_if3, fpts_if], dim=1)
    w_if = torch.cat([w_if3, fw_if], dim=1)

    g = multilinear_grad("hex", vals, pts_if)  # original-orientation normal
    gn = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    nref = g / gn.clamp_min(_TINY)
    return CutRule(pts, w, side, pts_if, w_if, nref)
