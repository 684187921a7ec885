"""Space-time cut quadrature rules.

Counterpart of ``ngsxfem_tpu/ops/spacetimecut.py`` (the reference's
space-time rule, ``cutint/spacetimecutrule.cpp:97-196``): the level set on a
tensor-product space-time element is a matrix of (time-node x space-vertex)
values; the spatial sign pattern changes only where a vertex's time
polynomial crosses zero, so the time axis is sliced at those roots (closed
form for k_t <= 2, a fixed 40-step bisection above, cf. root_finding
:6-95), a Gauss rule is placed on each slice, and the spatial straight-cut
rule (``cut_rule_element``) is built at every time point, all as batched
tensors of fixed shape on the device of the values.  ``spacetime_split``
separates the elements whose rule is the plain one (no slice of positive
length besides [0, 1], one sign throughout) from those that need the cut
rule, so the integrators build the cut rule on the cut elements only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.timing import count, traced
from .gauss import gauss_legendre_01
from .straightcut import cut_rule_element, cut_rule_simplices, eps_guard


class SpaceTimeCutRule(NamedTuple):
    """Padded space-time quadrature tensors (element-reference coords +
    time).

    Volume: pts (E,Q,d), times (E,Q), w (E,Q), side (E,Q).
    Lateral interface: pts_if (E,QI,d), times_if (E,QI), w_if (E,QI)
    (reference weights, measured as dt x spatial interface measure), nref
    (E,QI,d).
    """

    pts: torch.Tensor
    times: torch.Tensor
    w: torch.Tensor
    side: torch.Tensor
    pts_if: torch.Tensor
    times_if: torch.Tensor
    w_if: torch.Tensor
    nref: torch.Tensor


def time_gauss(order_time: int, dtype, device):
    """(points, weights) of the Gauss rule on [0,1] that integrates degree
    ``order_time`` in time exactly, as tensors."""
    tg, tw = gauss_legendre_01(max(1, (order_time + 2) // 2))
    return (torch.as_tensor(tg, dtype=dtype, device=device),
            torch.as_tensor(tw, dtype=dtype, device=device))


def time_tensorize(rp, rw, time_order, nref=None):
    """Tensorize a rule (R|1, Q, ...) with the time Gauss points of
    ``time_order``: point q at time point k in slot q*nt + k, as the JAX
    package's plain space-time rules (``_time_tensorize_param``).  Returns
    (rp, rw, nref, times (R|1, Q*nt)); times is None, and nothing changes,
    when ``time_order < 0``."""
    if time_order < 0:
        return rp, rw, nref, None
    tg, tw = time_gauss(time_order, rw.dtype, rw.device)
    nt = len(tg)
    R, Q = rw.shape
    rp = rp.repeat_interleave(nt, dim=1)
    rw = (rw[:, :, None] * tw).reshape(R, Q * nt)
    if nref is not None:
        nref = nref.repeat_interleave(nt, dim=1)
    return rp, rw, nref, tg.repeat(Q)[None].expand(R, Q * nt)


def _poly_roots_in_01(coefs, kt: int, nbisect: int = 40):
    """Roots of per-vertex time polynomials inside (0,1).

    coefs (..., kt+1) monomial coefficients (c0 + c1 t + ...).  Returns
    (..., R) candidate roots clamped to [0,1] (invalid slots -> 0, harmless
    as slice boundaries).  Closed form for kt <= 2 (R = kt); for kt >= 3,
    2*kt equal subintervals and a bisection in each that changes sign
    (R = 2*kt), the granularity of the reference's root_finding
    (cutint/spacetimecutrule.cpp:6-95).
    """
    if kt == 0:
        return torch.zeros(coefs.shape[:-1] + (1,), dtype=coefs.dtype,
                           device=coefs.device)
    if kt == 1:
        a, b = coefs[..., 0], coefs[..., 1]
        t = -a / torch.where(b.abs() < 1e-30, 1.0, b)
        return t.clamp(0.0, 1.0)[..., None]
    if kt == 2:
        c, b, a = coefs[..., 0], coefs[..., 1], coefs[..., 2]
        # a t^2 + b t + c = 0
        lin = -c / torch.where(b.abs() < 1e-30, 1.0, b)  # for a ~ 0
        disc = b * b - 4 * a * c
        sq = torch.sqrt(disc.clamp_min(0.0))
        den = 2 * torch.where(a.abs() < 1e-30, 1.0, a)
        t1 = (-b - sq) / den
        t2 = (-b + sq) / den
        small_a = a.abs() < 1e-12
        no_root = disc < 0
        t1 = torch.where(small_a, lin, torch.where(no_root, 0.0, t1))
        t2 = torch.where(small_a, 0.0, torch.where(no_root, 0.0, t2))
        return torch.stack([t1.clamp(0, 1), t2.clamp(0, 1)], dim=-1)

    nsub = 2 * kt

    def peval(t):
        out = torch.zeros(t.shape, dtype=coefs.dtype, device=coefs.device)
        for j in range(kt, -1, -1):
            out = out * t + coefs[..., None, j]
        return out

    edges = torch.linspace(0.0, 1.0, nsub + 1, dtype=coefs.dtype,
                           device=coefs.device)
    lo = torch.broadcast_to(edges[:-1], coefs.shape[:-1] + (nsub,))
    hi = torch.broadcast_to(edges[1:], coefs.shape[:-1] + (nsub,))
    flo = peval(lo)
    has = (flo * peval(hi)) < 0  # (..., nsub)
    for _ in range(nbisect):
        mid = 0.5 * (lo + hi)
        fm = peval(mid)
        go_left = (flo * fm) < 0
        lo, hi = torch.where(go_left, lo, mid), torch.where(go_left, mid, hi)
        flo = torch.where(go_left, flo, fm)
    return torch.where(has, 0.5 * (lo + hi), 0.0)  # (..., nsub) candidates


def _st_coefs(vals_st, kt: int):
    """(E, nvel, kt+1) monomial time polynomials of the guarded nodal
    values (E, nd_t, nvel)."""
    from ..spacetime.timefe import _time_coeff

    C = torch.as_tensor(_time_coeff(kt), dtype=vals_st.dtype,
                        device=vals_st.device)  # (nm, nd_t) mono->nodal
    # "mt,etv->evm": phi_v(t) = sum_m c_m t^m
    return (C[None, None] * vals_st.transpose(1, 2)[:, :, None, :]).sum(-1)


def _st_slices(coefs, kt: int, order_time: int):
    """Slice [0,1] at the vertex-polynomial roots and place a Gauss rule on
    each slice.  coefs (E, nvel, kt+1) monomial time polynomials per
    vertex.  Returns (tpts (E,T), twts (E,T), vv (E,T,nvel) spatial vertex
    values at each time point, roots (E, K))."""
    E = coefs.shape[0]
    dtype, device = coefs.dtype, coefs.device
    roots = _poly_roots_in_01(coefs, kt)
    roots = roots.reshape(E, roots.shape[1] * roots.shape[2])  # (E, K)
    # slice boundaries: sorted {0, roots..., 1}
    bnds = torch.sort(torch.cat(
        [torch.zeros((E, 1), dtype=dtype, device=device), roots,
         torch.ones((E, 1), dtype=dtype, device=device)], dim=1), dim=1)[0]
    t0 = bnds[:, :-1]  # (E, K+1) interval starts
    dt = bnds[:, 1:] - bnds[:, :-1]  # lengths (>= 0)
    tg, tw = time_gauss(order_time, dtype, device)
    T = t0.shape[1] * len(tg)
    tpts = (t0[:, :, None] + dt[:, :, None] * tg).reshape(E, T)
    twts = (dt[:, :, None] * tw).reshape(E, T)
    # spatial vertex values at each time point: "etm,evm->etv"
    tm = torch.stack([tpts**j for j in range(kt + 1)], dim=-1)  # (E,T,nm)
    vv = (tm[:, :, None, :] * coefs[:, None, :, :]).sum(-1)
    return tpts, twts, vv, roots


@traced("SpaceTimeCutRule")
def spacetime_cut_rule(et: str, vals_st, kt: int, order_space: int,
                       order_time: int, policy: str = "OPTIMAL"):
    """Space-time cut rule for a batch of elements.

    vals_st (E, nd_t, nvel): level-set values at (time node, space
    vertex); kt = time order of the level set.  The spatial rule at each
    time point is ``cut_rule_element``, the same dispatch as the stationary
    integrator (simplex tables; the multilinear QUAD/HEX rules under
    ``policy``), so stationary and space-time integrals agree on identical
    vertex values.  A span ``SpaceTimeCutRule``, counting its elements
    (``SpaceTimeCutRule::elements``).
    """
    E, ndt, nvel = vals_st.shape
    count("SpaceTimeCutRule::elements", E)
    coefs = _st_coefs(eps_guard(vals_st), kt)
    tpts, twts, vv, _ = _st_slices(coefs, kt, order_time)
    T = tpts.shape[1]
    r = cut_rule_element(et, vv.reshape(E * T, nvel), order_space, policy)
    return _st_assemble(r, tpts, twts)


def spacetime_cut_rule_simplices(coords, vals_a, vals_b, d: int,
                                 order_space: int, order_time: int):
    """Space-time (k_t = 1) cut rule on a batch of arbitrary d-simplices:
    the subdivision engine's kernel (the counterpart of the reference
    legacy engine's ``NumericalIntegrationStrategy<ET_SPACE, ET_TIME>``,
    cutint/xintegration.cpp).  ``coords (B, d+1, d)`` are simplex vertices
    in element-reference space, ``vals_a``/``vals_b (B, d+1)`` the level
    set at those vertices at the (sub-)slab's local t = 0 / t = 1.  The
    spatial rule per time point is ``cut_rule_simplices``, so the weights
    carry the sub-simplex measure."""
    B, nv = vals_a.shape
    vals_a = eps_guard(vals_a)
    vals_b = eps_guard(vals_b)
    coefs = torch.stack([vals_a, vals_b - vals_a], dim=-1)  # (B, nv, 2)
    tpts, twts, vv, _ = _st_slices(coefs, 1, order_time)
    T = tpts.shape[1]
    coords_rep = coords[:, None].expand((B, T) + tuple(coords.shape[1:]))
    r = cut_rule_simplices(coords_rep.reshape((B * T,) + tuple(coords.shape[1:])),
                           vv.reshape(B * T, nv), d, order_space)
    return _st_assemble(r, tpts, twts)


def spacetime_split(vals_st, kt: int, order_time: int):
    """Classify elements for the two quadrature tiers: (E,) int8, 0 / 1
    where the element's space-time rule equals the plain spatial rule x the
    time Gauss rule on the NEG / POS side (every root candidate at 0 or 1,
    every vertex value at every time point of one sign), -1 where it needs
    ``spacetime_cut_rule``."""
    coefs = _st_coefs(eps_guard(vals_st), kt)
    _, _, vv, roots = _st_slices(coefs, kt, order_time)
    g = eps_guard(vv)
    plain = ((roots == 0) | (roots == 1)).all(1)
    neg = plain & (g < 0).all(2).all(1)
    pos = plain & (g > 0).all(2).all(1)
    out = torch.full(neg.shape, -1, dtype=torch.int8, device=neg.device)
    out[neg] = 0
    out[pos] = 1
    return out


def _st_assemble(r, tpts, twts):
    """Fold the per-(element, time point) spatial CutRule ``r`` into one
    SpaceTimeCutRule: time weights folded into the quadrature weights
    (iterated-integral convention: the IF space-time integral is dt x the
    spatial interface measure, as the reference's
    SpaceTimeCutIntegrationRule)."""
    E, T = tpts.shape

    def merge(a):  # (E*T, q, ...) -> (E, T*q, ...)
        return a.reshape(E, T * a.shape[1], *a.shape[2:])

    def fold_time(w):
        q = w.shape[1]
        return (w.reshape(E, T, q) * twts[:, :, None]).reshape(E, T * q)

    def time_of(qn):
        return tpts[:, :, None].expand(E, T, qn).reshape(E, T * qn)

    return SpaceTimeCutRule(
        merge(r.pts), time_of(r.pts.shape[1]), fold_time(r.w), merge(r.side),
        merge(r.pts_if), time_of(r.pts_if.shape[1]), fold_time(r.w_if),
        merge(r.nref))
