"""Numerical integration over implicit domains — the `Integrate` entry point.

Counterpart of ``ngsxfem_tpu/integrate.py`` (the reference's ``IntegrateX``,
``cutint/python_cutint.cpp:20-122``): instead of a per-element loop
building one rule at a time, all elements of a tier get padded cut-rule
tensors (ops/straightcut.py) and the integral is one batched
evaluate-multiply-reduce, eagerly on the device of the level set.

Two tiers, as in the reference's default path: elements that the level set
does not cut take the element's standard rule, and only the cut elements
(found exactly with ``torch.nonzero``) run the cut-rule construction.  A
mesh deformation (``mesh.SetDeformation`` or ``deformation=``) enters every
tier through the evaluation context.  Space-time integrals
(``time_order >= 0``, a space-time P1 level set or a spatial one taken as
constant in time) split the same way: ``ops.spacetimecut.spacetime_split``
finds the elements whose space-time rule is the plain spatial rule x the
time Gauss rule, and only the others run ``spacetime_cut_rule``.

``subdivlvl > 0`` keeps the level set a genuine CoefficientFunction (the
reference's legacy adaptive engine, cutint/xintegration.cpp:698+): it is
evaluated on the dyadic subdivision lattice of every element
(``ops/subdivide.py``) and the straight-cut rule runs on the sub-simplices.
``Integrate`` takes three tiers, as the JAX package's banded path does:
elements of one sign take their plain rule, descendants of the sign-uniform
depth-1 children of the band take their mapped plain rules, and only the
mixed depth-1 children run the cut rule; the band and the mixed children
are taken exactly with ``torch.nonzero``.  The forms, and space-time
integrals, take the uniform rule on every element.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .parallel.sharding import mesh_shard, sum_over_ranks
from .config import config, resolve_device
from .domaintype import DOMAIN_TYPE, NEG, POS, IF
from .cf.coefficient import wrap
from .cf.context import EvalCtx, eval_pure
from .fem.basis import lagrange_element
from .ops.gauss import reference_rule
from .ops.straightcut import cut_rule_element, cut_rule_simplices, eps_guard
from .ops.subdivide import child_tables, subdivision_tables


def vertex_local_ids(et: str, order: int):
    """Indices of the Lagrange nodes sitting at the element vertices, in
    REF_VERTS order (local node layout is lexicographic, not vertex-major)."""
    from .ops.cuttables import REF_VERTS

    nodes = lagrange_element(et, order)["nodes"]
    refv = REF_VERTS[et]
    ids = []
    for v in refv:
        d = np.linalg.norm(nodes - v[None, :], axis=1)
        j = int(np.argmin(d))
        assert d[j] < 1e-12, "vertex node missing"
        ids.append(j)
    return np.array(ids, dtype=np.int32)


def _is_p1(gf):
    from .fem.gridfunction import GridFunction
    from .fem.space import H1

    return (isinstance(gf, GridFunction) and isinstance(gf.space, H1)
            and gf.space.order == 1)


def lset_vertex_values(lset_gf):
    """Per-element level-set vertex values (E, nvel) from a P1 GridFunction."""
    if not _is_p1(lset_gf):
        raise TypeError(
            "levelset must be a GridFunction on H1(order=1); "
            "use InterpolateToP1 first (cf. reference CreateCutIntegrationRule)"
        )
    sp = lset_gf.space
    vperm = torch.as_tensor(vertex_local_ids(sp.mesh.et, 1), dtype=torch.int64,
                            device=lset_gf.device)
    return lset_gf.vec.data[sp.el2dof_on(lset_gf.device)[:, vperm]]


def lset_st_vertex_values(lset_gf):
    """(E, ndt, nvel) level-set values of a space-time P1 GridFunction.

    A purely spatial P1 GridFunction is accepted too and broadcast constant
    in time over two time nodes (k_t=1), as the reference routes a spatial
    level set through space-time integrals (the all-NEG dummy level set of
    the fitted heat solve, ``tests/pytests/test_spacetimecutrule.py:106-115``).
    """
    from .spacetime.space import SpaceTimeFESpace

    sp = lset_gf.space
    if not isinstance(sp, SpaceTimeFESpace):
        vals = lset_vertex_values(lset_gf)  # validates spatial P1
        return vals[:, None, :].expand(vals.shape[0], 2, vals.shape[1])
    if sp.spacefes.order != 1:
        raise TypeError("space-time levelset must live on SpaceTimeFESpace "
                        "over H1(order=1)")
    if sp.ndof_t != sp.k_t + 1:
        # the nodal time polynomials below need the full Gauss-Lobatto node
        # set; a reduced space would silently build wrong polynomials
        raise TypeError("level sets on reduced time spaces "
                        "(skip_first_node/only_first_node) are not supported")
    dev = lset_gf.device
    vperm = torch.as_tensor(vertex_local_ids(sp.mesh.et, 1), dtype=torch.int64,
                            device=dev)
    sdofs = sp.spacefes.el2dof_on(dev)[:, vperm]  # (E, nvel) spatial dofs
    vec = lset_gf.vec.data
    return torch.stack([vec[t * sp.ndof_s + sdofs] for t in range(sp.ndof_t)],
                       dim=1)


def _lset_time_order(lset_gf):
    """Time order of a level set's vertex polynomials (1 for a spatial
    level set, broadcast over two nodes)."""
    return getattr(lset_gf.space, "k_t", 1)


def _p1_vertex_dofs(space):
    """vertex id -> P1 dof id (host numpy), cached on the space."""
    vd = getattr(space, "_p1_vertex_dofs_np", None)
    if vd is None:
        vperm = vertex_local_ids(space.mesh.et, 1)
        vd = np.zeros(space.mesh.nv, dtype=np.int32)
        vd[space.mesh.elements_np] = space.el2dof_np[:, vperm]
        space._p1_vertex_dofs_np = vd
    return vd


def _is_spacetime_gf(gf):
    from .fem.gridfunction import GridFunction
    from .spacetime.space import SpaceTimeFESpace

    return isinstance(gf, GridFunction) and isinstance(gf.space,
                                                       SpaceTimeFESpace)


def ensure_p1_levelset(levelset, mesh, device=None, cache_on=None):
    """Route non-P1 level sets to the straight-cut path by interpolation.

    The reference shortcut (``CF2GFForStraightCutRule``,
    cutint/xintegration.cpp:91-103) requires a P1 GridFunction and otherwise
    falls back to its legacy adaptive engine, which is not reproduced: a
    CoefficientFunction level set is interpolated to P1 on ``device`` (with
    a warning when the P1 space is built), the same geometry approximation
    as InterpolateToP1 + straight cut.  A P1 GridFunction, and a space-time
    GridFunction, is returned as it is.

    With a holder ``cache_on`` (the CF itself, an integrator, a CutInfo)
    the P1 GridFunction is kept on it and reused while the mesh, its
    ``_version`` (bumped by ``Refine`` and by (un)setting a deformation),
    the device and the dtype are the same; it is re-interpolated on every
    call, as the JAX package does, so an updated level set is never served
    stale."""
    if _is_p1(levelset) or _is_spacetime_gf(levelset):
        return levelset
    from .fem.gridfunction import GridFunction, InterpolateToP1
    from .fem.space import H1

    dev = resolve_device(device)
    key = (mesh._version, str(dev), config.dtype)
    cache = (getattr(cache_on, "_p1_lset_cache", None)
             if cache_on is not None else None)
    hit = cache.get(id(mesh)) if cache else None
    if hit is not None and hit[0] == key and hit[1] is levelset:
        gf = hit[2]
    else:
        warnings.warn(
            "level set is not a P1 GridFunction; interpolating to P1 for the "
            "straight-cut rule (the reference would route to its legacy "
            "adaptive engine here, cutint/xintegration.cpp:91-103, which is "
            "not reproduced)", stacklevel=3)
        gf = GridFunction(H1(mesh, order=1), device=dev)
        if cache_on is not None:
            if cache is None:
                cache = {}
                try:
                    cache_on._p1_lset_cache = cache
                except AttributeError:
                    cache = None  # a slotted holder: no caching
            if cache is not None:
                # one entry per mesh (the GridFunction keeps the mesh alive,
                # so its id is not reused while the entry exists)
                cache[id(mesh)] = (key, levelset, gf)
    InterpolateToP1(levelset, gf)
    return gf


def normalize_levelset_domain(levelset_domain: dict):
    ld = dict(levelset_domain)
    ld.setdefault("subdivlvl", 0)
    ld.setdefault("force_intorder", -1)
    ld["quad_dir_policy"] = str(ld.get("quad_dir_policy", "OPTIMAL"))
    if ld["quad_dir_policy"] not in ("FIRST", "OPTIMAL", "FALLBACK"):
        raise ValueError(
            f"unknown quad_dir_policy {ld['quad_dir_policy']!r}; "
            "expected FIRST, OPTIMAL or FALLBACK"
        )
    lvl = int(ld["subdivlvl"])
    if lvl < 0:
        raise ValueError("subdivlvl must be >= 0")
    ld["subdivlvl"] = lvl
    return ld


def _rule_ctx_weights(mesh, dt, pts, w, side, pts_if, w_if, nref,
                      elem_ids=None, deformation="inherit", times=None,
                      times_if=None):
    """Rule tensors -> (ctx, physical weights, validity mask): IF rules get
    the ``‖J⁻ᵀn_ref‖·|detJ|`` interface weighting, NEG/POS rules the side
    selection x ``|detJ|``.  ``elem_ids`` restricts the rows to an element
    subset; ``deformation`` is passed to the context (``EvalCtx``), and so
    are the points' slab times of a space-time rule (``times`` of the
    volume part, ``times_if`` of the interface part)."""
    if dt == IF:
        ctx = EvalCtx(mesh, pts_if, nref=nref, elem_ids=elem_ids,
                      deformation=deformation, time=times_if)
        w_ref = w_if
        w_phys = w_ref * ctx.detJ.abs() * ctx.if_scale
    else:
        ctx = EvalCtx(mesh, pts, elem_ids=elem_ids, deformation=deformation,
                      time=times)
        w_ref = w * (side == int(dt)).to(w.dtype)
        w_phys = w_ref * ctx.detJ.abs()
    return ctx, w_phys, w_ref > 0


def tier_rows(mesh, sel, sharded=False):
    """(ids, full) of a tier: the elements of the (ne,) mask ``sel`` this
    rank computes, and None, or, with ``sharded`` on a sharded mesh
    (``parallel.sharding.shard_mesh``), the owned elements only and
    ``full = (every id of the tier, positions of ids among them)``, from
    which the forms lay the rank's rows out in the single-rank order."""
    ids = torch.nonzero(sel)[:, 0]
    sh = mesh_shard(mesh) if sharded else None
    if sh is None:
        return ids, None
    keep = sh.own_on(sel.device)[ids]
    return ids[keep], (ids, torch.nonzero(keep)[:, 0])


def _with_rows(ctx, full):
    """``ctx`` carrying the single-rank layout of its rows (``tier_rows``)."""
    ctx.shard_full = full
    return ctx


def two_tier_tiers(mesh, lgf, dt, order, policy, deform="inherit",
                   sharded=False):
    """Two-tier cut quadrature tiers [(ctx, w_phys (R,Q), mask, elem_ids)]:
    the standard rule on the uncut elements of the requested side (NEG/POS
    only), and the cut rule on the cut elements, each set taken exactly with
    ``torch.nonzero``.  The cut-rule construction then scales with the
    interface, not the volume.  ``deform`` is the deformation of both
    tiers' contexts (``EvalCtx``).  With ``sharded`` on a sharded mesh each
    tier keeps this rank's elements (``tier_rows``)."""
    dt = int(dt)
    if dt not in (int(NEG), int(POS), int(IF)):
        raise ValueError(
            f"two-tier cut quadrature supports NEG/POS/IF, got {dt}")
    vals = eps_guard(lset_vertex_values(lgf))
    has_neg = (vals < 0).any(1)
    has_pos = (vals > 0).any(1)
    tiers = []
    if dt != int(IF):
        sel = (has_neg & ~has_pos) if dt == int(NEG) else (has_pos & ~has_neg)
        ids, full = tier_rows(mesh, sel, sharded)
        rp, rw = reference_rule(mesh.et, order)
        pts = torch.as_tensor(rp, dtype=vals.dtype, device=vals.device)[None]
        ctx = _with_rows(EvalCtx(mesh, pts, elem_ids=ids, deformation=deform),
                         full)
        w = torch.as_tensor(rw, dtype=vals.dtype, device=vals.device) \
            * ctx.detJ.abs()
        w = w.expand(len(ids), len(rw))
        tiers.append((ctx, w, torch.ones_like(w, dtype=torch.bool), ids))
    cut_ids, full = tier_rows(mesh, has_neg & has_pos, sharded)
    rule = cut_rule_element(mesh.et, vals[cut_ids], order, policy)
    ctx, w, mask = _rule_ctx_weights(mesh, dt, *rule, elem_ids=cut_ids,
                                     deformation=deform)
    tiers.append((_with_rows(ctx, full), w, mask, cut_ids))
    return tiers


def spacetime_tiers(mesh, lgf, dt, order, time_order, policy,
                    deform="inherit", sharded=False):
    """The two tiers of a space-time cut integral, as ``two_tier_tiers``
    gives them: the plain spatial rule x the time Gauss rule on the
    elements that ``spacetime_split`` finds on the requested side (NEG/POS
    only), and ``spacetime_cut_rule`` on the others.  Each tier's context
    carries the points' slab times."""
    from .ops.spacetimecut import (spacetime_cut_rule, spacetime_split,
                                   time_tensorize)

    dt = int(dt)
    if dt not in (int(NEG), int(POS), int(IF)):
        raise ValueError(
            f"space-time cut quadrature supports NEG/POS/IF, got {dt}")
    vals = lset_st_vertex_values(lgf)
    kt = _lset_time_order(lgf)
    split = spacetime_split(vals, kt, time_order)
    tiers = []
    if dt != int(IF):
        ids, full = tier_rows(mesh, split == dt, sharded)
        rp, rw = reference_rule(mesh.et, order)
        pts, rw, _, times = time_tensorize(
            torch.as_tensor(rp, dtype=vals.dtype, device=vals.device)[None],
            torch.as_tensor(rw, dtype=vals.dtype, device=vals.device)[None],
            time_order)
        ctx = _with_rows(EvalCtx(mesh, pts, elem_ids=ids, deformation=deform,
                                 time=times), full)
        w = (rw * ctx.detJ.abs()).expand(len(ids), rw.shape[1])
        tiers.append((ctx, w, torch.ones_like(w, dtype=torch.bool), ids))
    cut_ids, full = tier_rows(mesh, split < 0, sharded)
    rule = spacetime_cut_rule(mesh.et, vals[cut_ids], kt, order, time_order,
                              policy)
    pts, times, w, side, pts_if, times_if, w_if, nref = rule
    ctx, w, mask = _rule_ctx_weights(mesh, dt, pts, w, side, pts_if, w_if,
                                     nref, elem_ids=cut_ids,
                                     deformation=deform, times=times,
                                     times_if=times_if)
    tiers.append((_with_rows(ctx, full), w, mask, cut_ids))
    return tiers


def cut_tiers(mesh, lgf, dt, order, policy, time_order=-1, deform="inherit",
              sharded=False):
    """``two_tier_tiers``, or ``spacetime_tiers`` for ``time_order >= 0``."""
    if time_order >= 0:
        return spacetime_tiers(mesh, lgf, dt, order, time_order, policy,
                               deform, sharded)
    return two_tier_tiers(mesh, lgf, dt, order, policy, deform, sharded)


def _rank_sum(mesh, out, ew):
    """The per-element sums ``out`` (ne,) of this rank's elements summed
    over the ranks of a sharded mesh: the (ne,) vector when ``ew``, else
    the 0-d integral (one all-reduced scalar)."""
    if ew:
        return sum_over_ranks(mesh, out)
    return sum_over_ranks(mesh, out.sum().reshape(1))[0]


def _two_tier_integrate(mesh, cf, lgf, dt, order, policy, ew, time_order=-1):
    """Two-tier cut integration of a CoefficientFunction over the tiers of
    ``cut_tiers``: per-element sums (ne,) when ``ew``, else the 0-d
    integral.  On a sharded mesh each rank integrates its elements and the
    result is summed over the ranks."""
    tiers = cut_tiers(mesh, lgf, dt, order, policy, time_order, sharded=True)
    total_e = torch.zeros(mesh.ne, dtype=lgf.dtype, device=lgf.device)
    for ctx, w, mask, ids in tiers:
        f = torch.broadcast_to(eval_pure(cf, ctx), w.shape)
        total_e.index_add_(0, ids, (torch.where(mask, f, 0.0) * w).sum(1))
    return _rank_sum(mesh, total_e, ew)


def _lattice_values(mesh, levelset, lattice, device, deformation):
    """(E, nlat) eps-guarded level-set values at the subdivision lattice
    (reference coordinates) of every element."""
    lat = torch.as_tensor(lattice, dtype=config.dtype, device=device)[None]
    ctx = EvalCtx(mesh, lat, deformation=deformation)
    vals = torch.broadcast_to(eval_pure(wrap(levelset), ctx),
                              (mesh.ne, lattice.shape[0]))
    return eps_guard(vals)


def subdiv_ctx_and_weights(mesh, levelset, domain_type, order, lvl, device,
                           deformation="inherit"):
    """(ctx, physical weights, validity mask) of the uniform subdivision
    rule on every element: the level set, a CoefficientFunction, is
    evaluated at each element's level-``lvl`` lattice and the straight-cut
    rule runs on all its sub-simplices (the reference's legacy engine,
    cutint/xintegration.cpp:698+, without its pruning)."""
    dt = DOMAIN_TYPE(int(domain_type))
    d, E = mesh.dim, mesh.ne
    lattice, subs = subdivision_tables(mesh.et, lvl)
    vals = _lattice_values(mesh, levelset, lattice, device, deformation)
    nsub = subs.shape[0]
    coords = torch.as_tensor(lattice[subs], dtype=config.dtype, device=device)
    coords = coords[None].expand(E, nsub, d + 1, d).reshape(E * nsub, d + 1, d)
    subs_t = torch.as_tensor(subs, dtype=torch.int64, device=device)
    svals = vals[:, subs_t].reshape(E * nsub, d + 1)
    r = cut_rule_simplices(coords, svals, d, order)
    merge = lambda a: a.reshape((E, nsub * a.shape[1]) + tuple(a.shape[2:]))
    return _rule_ctx_weights(mesh, dt, *(merge(a) for a in r),
                             deformation=deformation)


def subdiv_tiers(mesh, levelset, domain_type, order, lvl, device,
                 deformation="inherit"):
    """The three tiers [(ctx, w_phys, mask, elem_ids)] of a ``subdivlvl >
    0`` integral, the reference legacy engine's pruned work
    (cutint/xintegration.cpp:738-852, ``Simplex::CheckIfCut``,
    xdecompose.hpp:34-87):

    * elements whose lattice values all have the requested sign take the
      element's plain rule (NEG/POS only);
    * in the band of elements with both signs, the descendants of depth-1
      children that are sign-uniform over their own lattice points take
      their mapped plain rules when they lie on the requested side
      (NEG/POS only);
    * only the mixed depth-1 children run their descendants through the
      straight-cut rule.

    The band and the mixed children are taken exactly (``torch.nonzero``);
    an element id repeats in the last tier once per mixed child."""
    dt = DOMAIN_TYPE(int(domain_type))
    d, E = mesh.dim, mesh.ne
    dtype = config.dtype
    lattice, subs, child_pts, nchild, g = child_tables(mesh.et, lvl)
    vals = _lattice_values(mesh, levelset, lattice, device, deformation)
    neg_any = (vals < 0).any(1)
    pos_any = (vals > 0).any(1)
    mixed = neg_any & pos_any
    simplex = "trig" if d == 2 else "tet"
    cp, cw = reference_rule(simplex if mesh.et in ("quad", "hex")
                            else mesh.et, order)
    as_t = lambda a, dt_=dtype: torch.as_tensor(a, dtype=dt_, device=device)
    tiers = []
    if dt != IF:
        cpe, cwe = reference_rule(mesh.et, order)
        ids = torch.nonzero((~mixed) & (neg_any if dt == NEG
                                        else pos_any))[:, 0]
        ctx = EvalCtx(mesh, as_t(cpe)[None], elem_ids=ids,
                      deformation=deformation)
        w = (as_t(cwe) * ctx.detJ.abs()).expand(len(ids), len(cwe))
        tiers.append((ctx, w, (as_t(cwe) > 0).expand(len(ids), len(cwe)),
                      ids))

    band = torch.nonzero(mixed)[:, 0]
    bvals = vals[band]
    cvals = bvals[:, as_t(child_pts, torch.int64)]  # (nband, nchild, L)
    child_mixed = (cvals < 0).any(2) & (cvals > 0).any(2)
    subs_t = as_t(subs, torch.int64)
    nsub = subs.shape[0]
    if dt != IF:
        # descendants of sign-uniform children: plain rules mapped onto
        # each descendant simplex (host tables)
        nq = cp.shape[0]
        v0 = lattice[subs][:, 0]
        M = lattice[subs][:, 1:] - v0[:, None]
        desc_pts = v0[:, None, :] + np.einsum("qk,skd->sqd", cp, M)
        w_desc = cw[None, :] * np.abs(np.linalg.det(M))[:, None]
        ctx = EvalCtx(mesh, as_t(desc_pts.reshape(1, nsub * nq, d)),
                      elem_ids=band, deformation=deformation)
        dvals = bvals[:, subs_t]  # (nband, nsub, d+1)
        side = (dvals < 0).all(2) if dt == NEG else (dvals > 0).all(2)
        child_of_desc = torch.arange(nchild, device=device).repeat_interleave(g)
        selp = side & ~child_mixed[:, child_of_desc]
        w = torch.where(selp[:, :, None], as_t(w_desc)[None], 0.0)
        w = w.reshape(len(band), nsub * nq) * ctx.detJ.abs()
        mask = (selp[:, :, None] & (as_t(cw) > 0)).reshape(len(band),
                                                            nsub * nq)
        tiers.append((ctx, w, mask, band))

    # the mixed depth-1 children: the cut rule on their descendants
    pick = torch.nonzero(child_mixed.reshape(-1))[:, 0]
    e3 = band[pick // nchild]
    c3 = pick % nchild
    sbc = subs_t.reshape(nchild, g, d + 1)[c3]  # (n3, g, d+1)
    n3 = len(pick)
    svals = vals[e3[:, None, None], sbc].reshape(n3 * g, d + 1)
    coords = as_t(lattice)[sbc].reshape(n3 * g, d + 1, d)
    r = cut_rule_simplices(coords, svals, d, order)
    merge = lambda a: a.reshape((n3, g * a.shape[1]) + tuple(a.shape[2:]))
    tiers.append((*_rule_ctx_weights(mesh, dt, *(merge(a) for a in r),
                                     elem_ids=e3, deformation=deformation),
                  e3))
    return tiers


def subdiv_st_ctx_and_weights(mesh, levelset, domain_type, order, lvl,
                              time_order, device, deformation="inherit"):
    """(ctx, physical weights, validity mask) of ``subdivlvl > 0`` with
    ``time_order >= 0`` (the reference legacy engine's space-time path,
    ``NumericalIntegrationStrategy<ET_SPACE, ET_TIME>``,
    cutint/xintegration.cpp:698+): the uniform dyadic subdivision in space
    x ``2^lvl`` uniform time sub-slabs.  The level set is evaluated once on
    the lattice at the ``2^lvl + 1`` sub-slab edge times, and one batched
    k_t = 1 space-time rule runs over all (element, sub-slab, sub-simplex)
    rows."""
    from .ops.spacetimecut import spacetime_cut_rule_simplices

    dt = DOMAIN_TYPE(int(domain_type))
    d, E = mesh.dim, mesh.ne
    lattice, subs = subdivision_tables(mesh.et, lvl)
    nlat, nsub = lattice.shape[0], subs.shape[0]
    S = 2 ** lvl  # time sub-slabs
    dtype = config.dtype
    edges = torch.linspace(0.0, 1.0, S + 1, dtype=dtype, device=device)
    lat = torch.as_tensor(lattice, dtype=dtype, device=device)
    pts = lat[None].expand(S + 1, nlat, d).reshape(1, (S + 1) * nlat, d)
    times = edges[:, None].expand(S + 1, nlat).reshape(1, (S + 1) * nlat)
    ctx = EvalCtx(mesh, pts, deformation=deformation, time=times)
    vals = torch.broadcast_to(eval_pure(wrap(levelset), ctx),
                              (E, (S + 1) * nlat)).reshape(E, S + 1, nlat)
    B = E * S * nsub
    coords = torch.as_tensor(lattice[subs], dtype=dtype, device=device)
    coords = coords[None, None].expand(E, S, nsub, d + 1, d).reshape(
        B, d + 1, d)
    subs_t = torch.as_tensor(subs, dtype=torch.int64, device=device)
    sa = vals[:, :-1][:, :, subs_t].reshape(B, d + 1)  # sub-slab start
    sb = vals[:, 1:][:, :, subs_t].reshape(B, d + 1)  # sub-slab end
    r = spacetime_cut_rule_simplices(coords, sa, sb, d, order, time_order)
    dt_s = 1.0 / S

    def emerge(a):  # (B, q, ...) -> (E, S*nsub*q, ...)
        return a.reshape((E, S * nsub * a.shape[1]) + tuple(a.shape[2:]))

    def to_global_time(tl):  # sub-slab local [0,1] -> slab time
        q = tl.shape[1]
        ta = edges[:-1][None, :, None, None].expand(E, S, nsub, q)
        return ta.reshape(E, S * nsub * q) + dt_s * emerge(tl)

    return _rule_ctx_weights(
        mesh, dt, emerge(r.pts), dt_s * emerge(r.w), emerge(r.side),
        emerge(r.pts_if), dt_s * emerge(r.w_if), emerge(r.nref),
        deformation=deformation, times=to_global_time(r.times),
        times_if=to_global_time(r.times_if))


def _subdiv_integrate(mesh, cf, ld, order, ew, time_order, device):
    """Integral of ``cf`` under a ``subdivlvl > 0`` level-set domain on the
    device of the level set's GridFunction, else on ``device``: the tiers
    of ``subdiv_tiers``, or in space-time the uniform rule on every
    element.  Per-element sums (ne,) when ``ew``, else the 0-d integral."""
    from .fem.gridfunction import GridFunction

    lset, lvl = ld["levelset"], ld["subdivlvl"]
    dev = (lset.device if isinstance(lset, GridFunction)
           else resolve_device(device))
    dt = int(ld["domain_type"])
    if time_order < 0:
        tiers = subdiv_tiers(mesh, lset, dt, order, lvl, dev)
    else:
        ctx, w, mask = _cut_ctx_and_weights(mesh, lset, dt, order,
                                            time_order, subdivlvl=lvl,
                                            device=dev)
        tiers = [(ctx, w, mask, None)]
    from .ops.scatter import ScatterPlan

    total_e = torch.zeros(mesh.ne, dtype=config.dtype, device=dev)
    for ctx, w, mask, ids in tiers:
        f = torch.broadcast_to(eval_pure(cf, ctx), w.shape)
        per = (torch.where(mask, f, 0.0) * w).sum(1)
        if ids is None:
            total_e += per
        else:  # ids repeat in the children's tier: a fixed-order sum
            ScatterPlan(ids, mesh.ne).add(per, total_e)
    sh = mesh_shard(mesh)
    if sh is not None:  # every rank computed every element: keep its own
        total_e = torch.where(sh.own_on(dev), total_e, 0.0)
    return _rank_sum(mesh, total_e, ew)


def _cut_ctx_and_weights(mesh, lset_gf, domain_type, order, time_order=-1,
                         quad_dir_policy="OPTIMAL", deformation="inherit",
                         subdivlvl=0, device=None):
    """(ctx, physical weights, validity mask) of the cut rule on every
    element of the mesh (one tier; ``cut_tiers`` splits it): the space-time
    rule for ``time_order >= 0``, the uniform subdivision rule of a level
    set CoefficientFunction for ``subdivlvl > 0`` (on ``device``)."""
    dt = DOMAIN_TYPE(int(domain_type))
    if subdivlvl > 0:
        if time_order >= 0:
            return subdiv_st_ctx_and_weights(mesh, lset_gf, dt, order,
                                             subdivlvl, time_order, device,
                                             deformation)
        return subdiv_ctx_and_weights(mesh, lset_gf, dt, order, subdivlvl,
                                      device, deformation)
    if time_order >= 0:
        from .ops.spacetimecut import spacetime_cut_rule

        pts, times, w, side, pts_if, times_if, w_if, nref = \
            spacetime_cut_rule(mesh.et, lset_st_vertex_values(lset_gf),
                               _lset_time_order(lset_gf), order, time_order,
                               quad_dir_policy)
        return _rule_ctx_weights(mesh, dt, pts, w, side, pts_if, w_if, nref,
                                 deformation=deformation, times=times,
                                 times_if=times_if)
    rule = cut_rule_element(mesh.et, lset_vertex_values(lset_gf), order,
                            quad_dir_policy)
    return _rule_ctx_weights(mesh, dt, *rule, deformation=deformation)


def Integrate(levelset_domain=None, cf=None, mesh=None, order=5,
              region_wise=False, element_wise=False, heapsize=None,
              deformation=None, time_order=-1, device=None, definedon=None,
              **kwargs):
    """Integrate `cf` over the mesh or an implicitly-defined subdomain.

    Mirrors the reference Python API (``python/__init__.py:312-378``):
      Integrate(levelset_domain={"levelset": lsetp1, "domain_type": NEG|POS|IF},
                cf=f, mesh=mesh, order=k)
    A non-dict first positional is the integrand (NGSolve-style
    ``Integrate(cf, mesh)``).  Runs on the device of the level set's
    GridFunction; with a CoefficientFunction level set, or no level set, on
    ``device`` (the card unless the caller asks for the CPU).  Returns a
    float, with ``element_wise`` a (ne,) tensor, with ``region_wise`` one
    numpy value per material.  ``definedon`` (a ``Region`` of
    ``mesh.Materials``, or an element mark array) restricts the integral
    to its elements.  ``deformation`` (a vector GridFunction) is set on the
    mesh for the call and unset afterwards, as in the JAX package; without
    it the mesh's own ``SetDeformation`` state applies.
    """
    if levelset_domain is not None and not isinstance(levelset_domain, dict):
        if cf is not None and mesh is None:
            levelset_domain, cf, mesh = None, levelset_domain, cf
        elif cf is None:
            levelset_domain, cf = None, levelset_domain
    if cf is None or mesh is None:
        raise TypeError("Integrate needs cf and mesh")
    if region_wise:
        # per-material sums in material-id order, from the element_wise
        # vector (the reference passes region_wise to NGSolve materials,
        # python/__init__.py:358)
        if element_wise:
            raise ValueError(
                "region_wise and element_wise are mutually exclusive")
    summed = not (element_wise or region_wise)
    element_wise = element_wise or region_wise or definedon is not None
    cf = wrap(cf)
    if cf.has_proxy:
        raise TypeError("cannot Integrate an expression containing trial/test functions")
    if cf.dims != ():
        raise TypeError("Integrate expects a scalar integrand")

    if deformation is not None:
        mesh.SetDeformation(deformation)
    try:
        if levelset_domain is None:
            dev = resolve_device(device)
            rp, rw = reference_rule(mesh.et, order)
            pts = torch.as_tensor(rp, dtype=config.dtype, device=dev)[None]
            ids, full = tier_rows(
                mesh, torch.ones(mesh.ne, dtype=torch.bool, device=dev), True)
            ctx = EvalCtx(mesh, pts, elem_ids=None if full is None else ids)
            w = torch.as_tensor(rw, dtype=config.dtype, device=dev) * ctx.detJ.abs()
            f = torch.broadcast_to(eval_pure(cf, ctx), (len(ids), len(rw)))
            out = torch.zeros(mesh.ne, dtype=config.dtype, device=dev) \
                .index_add_(0, ids, (f * w).sum(1))
            out = _rank_sum(mesh, out, element_wise)
        else:
            ld = normalize_levelset_domain(levelset_domain)
            time_order = int(ld.get("time_order", time_order))
            o = order if ld["force_intorder"] < 0 else ld["force_intorder"]
            if ld["subdivlvl"] > 0:
                out = _subdiv_integrate(mesh, cf, ld, o, element_wise,
                                        time_order, device)
            else:
                lgf = ensure_p1_levelset(
                    ld["levelset"], mesh, device,
                    cache_on=ld["levelset"])
                out = _two_tier_integrate(mesh, cf, lgf,
                                          int(ld["domain_type"]), o,
                                          ld["quad_dir_policy"],
                                          element_wise, time_order)
    finally:
        if deformation is not None:
            mesh.UnsetDeformation()
    if definedon is not None:
        from .fem.space import _arr

        out = torch.where(torch.as_tensor(_arr(definedon), device=out.device),
                          out, 0.0)
    if summed:
        return float(out.sum())
    if region_wise:
        ew = out.detach().cpu().numpy()
        ids = mesh.mat_of_el_np
        return np.array([float(ew[ids == i].sum())
                         for i in mesh.material_ids()])
    return out


def Integrate_X_special_args(levelset_domain, cf, mesh, order=5, **kw):
    """Reference-compat alias (python/__init__.py:281)."""
    return Integrate(levelset_domain, cf, mesh, order=order, **kw)
