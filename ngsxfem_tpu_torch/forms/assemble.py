"""Integrals, BilinearForm/LinearForm and batched assembly.

Counterpart of ``ngsxfem_tpu/forms/assemble.py`` (the replacement for the
reference's symbolic cut integrators, ``xfem/symboliccutbfi.*``,
``xfem/symboliccutlfi.*``, ``utils/restrictedblf.*``): each integral is
assembled for all (marked) elements at once — cut-rule tensors -> jet
evaluation -> one contraction per term -> COO scatter.  Sparsity
restriction (RestrictedBilinearForm) is implicit: only assembled entries
exist.

Ported: volume integrals (with or without a level-set domain, two quadrature
tiers as ``integrate.two_tier_tiers`` builds them), facet-patch integrals,
skeleton integrals (``skeleton=True``, with a cut rule on the facet itself
under a level-set domain), element-boundary integrals
(``element_boundary=True``) and boundary integrals (``VOL_or_BND=BND``, in
bilinear and linear forms), on scalar, vector, ``XFESpace`` and
``Compress``ed spaces and compounds of them.  The assembly is eager and takes
every selection exactly (facet and element marks select their rows), so the
reference's per-signature program cache and its capacity-padded dynamic
selections have no counterpart.  The COO rows and columns are gathered on
the device from the space's dof map; the values never leave it.  Not
ported, each raising ``NotImplementedError``: ``time_order >= 0`` (ROADMAP
A13), ``deformation`` (A11), ``subdivlvl > 0`` (A8b) and
``AssembleOperator`` (A10).
"""
from __future__ import annotations

import copy
import warnings

import numpy as np
import torch

from ..config import config
from ..cf.coefficient import CF, wrap
from ..cf.context import EvalCtx
from ..domaintype import IF, NEG, POS
from ..integrate import (_p1_vertex_dofs, ensure_p1_levelset,
                         normalize_levelset_domain, two_tier_tiers)
from ..mesh.mesh import (FACET_ET, FACET_VERTS, det_and_inv, geom_dshapes,
                         geom_shapes, map_points, small_matmul)
from ..ops.cuttables import ET_SPLIT, REF_VERTS
from ..ops.gauss import ET_DIM, reference_rule
from ..ops.scatter import ScatterPlan
from ..ops.straightcut import _gram_measure, cut_rule_simplices, eps_guard
from ..fem.space import CompoundFESpace, VectorFESpace, _arr
from ..solvers.sparse import SparseMatrix
from .evaluate import eval_form
from .proxies import ProxyFunction

VOL = "VOL"
BND = "BND"


class Integral:
    def __init__(self, form, levelset_domain=None, definedonelements=None,
                 element_boundary=False, skeleton=False, facet_patch=False,
                 force_intorder=-1, deformation=None, time_order=-1,
                 vb=VOL):
        self.form = wrap(form)
        self.levelset_domain = (
            normalize_levelset_domain(levelset_domain) if levelset_domain else None
        )
        self.definedonelements = (
            None if definedonelements is None else _arr(definedonelements).copy()
        )
        self.element_boundary = element_boundary
        self.skeleton = skeleton
        self.facet_patch = facet_patch
        self.force_intorder = force_intorder
        # dict-carried options (Integrate convention) apply here too
        if self.levelset_domain is not None:
            if time_order < 0:
                time_order = int(self.levelset_domain.get("time_order", -1))
            if force_intorder < 0:
                self.force_intorder = int(
                    self.levelset_domain.get("force_intorder", -1))
            if self.levelset_domain["subdivlvl"] > 0:
                raise NotImplementedError(
                    "subdivlvl > 0 (subdivision quadrature) is not ported "
                    "yet (ROADMAP A8b)")
        if vb not in (VOL, BND):
            raise NotImplementedError(
                f"VOL_or_BND={vb!r} integrals are not supported; "
                "an unsupported option must not silently assemble as VOL")
        if vb == BND and (element_boundary or skeleton or facet_patch):
            raise NotImplementedError(
                "VOL_or_BND=BND cannot be combined with element_boundary/"
                "skeleton/facet_patch integrals")
        self.vb = vb
        if time_order >= 0:
            raise NotImplementedError(
                "space-time integrals (time_order >= 0) are not ported yet "
                "(ROADMAP A13)")
        if deformation is not None:
            raise NotImplementedError(
                "mesh deformations are not ported yet (ROADMAP A11)")

    def SetDefinedOnElements(self, ba):
        """Re-mark this integral's element/facet selection (reference API:
        ``Integrator::SetDefinedOnElements``)."""
        self.definedonelements = _arr(ba).copy()


def SymbolicBFI(levelset_domain=None, form=None, VOL_or_BND=VOL, element_boundary=False,
                skeleton=False, definedonelements=None, deformation=None,
                force_intorder=-1, time_order=-1, **kw):
    """Cut/standard bilinear integrator descriptor (python/__init__.py:108)."""
    if form is None:  # allow SymbolicBFI(form) positional
        form, levelset_domain = levelset_domain, None
        if isinstance(form, dict):
            raise TypeError("SymbolicBFI needs form=...")
    return Integral(form, levelset_domain=levelset_domain,
                    definedonelements=definedonelements,
                    element_boundary=element_boundary, skeleton=skeleton,
                    force_intorder=force_intorder, deformation=deformation,
                    time_order=time_order, vb=VOL_or_BND)


def SymbolicLFI(levelset_domain=None, form=None, VOL_or_BND=VOL, definedonelements=None,
                deformation=None, force_intorder=-1, time_order=-1, **kw):
    if form is None:  # allow SymbolicLFI(form) positional
        form, levelset_domain = levelset_domain, None
        if isinstance(form, dict):
            raise TypeError("SymbolicLFI needs form=...")
    return Integral(form, levelset_domain=levelset_domain,
                    definedonelements=definedonelements,
                    force_intorder=force_intorder, deformation=deformation,
                    time_order=time_order, vb=VOL_or_BND)


def SymbolicFacetPatchBFI(form=None, skeleton=False, definedonelements=None,
                          force_intorder=-1, time_order=-1, deformation=None,
                          **kw):
    """Facet-patch (volumetric ghost penalty) integrator
    (xfem/symboliccutbfi.cpp:1104-1413)."""
    if skeleton:
        raise NotImplementedError("skeleton=True facet integrals: use SymbolicBFI")
    return Integral(form, facet_patch=True, definedonelements=definedonelements,
                    force_intorder=force_intorder, time_order=time_order,
                    deformation=deformation)


# ---------------------------------------------------------------------------


def _ensure_p1_ld(integral: Integral, mesh, device):
    """Route a non-P1 level set of an integral to P1 (CF fallback,
    cf. reference CF2GFForStraightCutRule, cutint/xintegration.cpp:91-103).

    The ORIGINAL level set is kept in the dict (``_orig_levelset``) so every
    Assemble re-interpolates it: an updated high-order/parametric level set
    must not reuse stale P1 geometry."""
    if integral.levelset_domain is None:
        return
    ld = integral.levelset_domain
    orig = ld.get("_orig_levelset", ld["levelset"])
    p1 = ensure_p1_levelset(orig, mesh, device)
    if p1 is not orig:
        ld["_orig_levelset"] = orig
    ld["levelset"] = p1


def _space_order(space):
    if isinstance(space, CompoundFESpace):
        return max(s.order for s in space.components)
    return space.order


def _block_space(space, blk):
    return space.components[blk] if isinstance(space, CompoundFESpace) else space


def _block_offset(space, blk):
    return int(space.offsets[blk]) if isinstance(space, CompoundFESpace) else 0


def block_dofmap(space, block_key, elem_ids_self, elem_ids_other=None, *,
                 device):
    """Global dof columns (E, ndl) int64 on ``device`` for a factor block;
    ``elem_ids_*`` are int64 tensors there, or None for all elements."""
    blk, other = block_key
    sp = _block_space(space, blk)
    e2d = (sp.block_el2dof_on(device) if isinstance(sp, VectorFESpace)
           else sp.el2dof_on(device))
    eids = elem_ids_other if other else elem_ids_self
    if eids is not None:
        e2d = e2d[eids]
    return e2d + _block_offset(space, blk)


def block_valid(space, block_key, elem_ids_self, elem_ids_other=None, *,
                device):
    """(E, ndl) bool on ``device``: False on the placeholder slots of a
    masked block space (``Compress``, ``XFESpace``), which carry no dof;
    None when every slot is a dof."""
    blk, other = block_key
    sp = _block_space(space, blk)
    valid = sp.el2dof_valid_on(device)
    if valid is None:
        return None
    if isinstance(sp, VectorFESpace):
        valid = valid.repeat(1, sp.vdim)
    eids = elem_ids_other if other else elem_ids_self
    return valid if eids is None else valid[eids]


def _intorder(integral, order):
    ld = integral.levelset_domain
    if ld is not None and ld["force_intorder"] >= 0:
        order = ld["force_intorder"]
    if integral.force_intorder >= 0:
        order = integral.force_intorder
    return order


def _volume_tiers(integral: Integral, mesh, order, device):
    """Quadrature tiers [(ctx, w_phys (R,Q), mask, elem_ids)] of a
    volume-type integral; ``elem_ids`` None means the rows are all elements.

    With a level-set domain these are the two tiers of
    ``integrate.two_tier_tiers``: the standard rule on the uncut elements of
    the requested side and the cut rule on the cut elements only, so the
    expensive path scales with the interface, not the volume."""
    o = _intorder(integral, order)
    if integral.levelset_domain is None:
        rp, rw = reference_rule(mesh.et, o)
        pts = torch.as_tensor(rp, dtype=config.dtype, device=device)[None]
        ctx = EvalCtx(mesh, pts)
        w = torch.as_tensor(rw, dtype=config.dtype, device=device) \
            * ctx.detJ.abs()
        w = w.expand(mesh.ne, len(rw))
        tiers = [(ctx, w, torch.ones_like(w, dtype=torch.bool), None)]
    else:
        ld = integral.levelset_domain
        tiers = two_tier_tiers(mesh, ld["levelset"], int(ld["domain_type"]),
                               o, ld["quad_dir_policy"])
    if integral.definedonelements is not None:
        sel = torch.as_tensor(integral.definedonelements, device=device)
        masked = []
        for ctx, w, mask, ids in tiers:
            s = (sel if ids is None else sel[ids])[:, None]
            masked.append((ctx, torch.where(s, w, 0.0), mask & s, ids))
        tiers = masked
    return tiers


def _facet_patch_fids(integral: Integral, mesh):
    """Selected interior facets of a facet-patch or skeleton integral (host
    numpy)."""
    sel = mesh.facet2el_np[:, 1] >= 0
    if integral.definedonelements is not None:  # facet mask here
        sel = sel & integral.definedonelements
    return np.nonzero(sel)[0]


def _facet_patch_ctx(integral: Integral, mesh, order, device):
    """Contexts for facet-patch integrals: union of both neighbor volume rules.

    Returns (ctx_self, elem_ids_self, elem_ids_other, w_phys, mask); ctx has
    ``other_ctx`` attached.  A point of one neighbour's rule is identified
    physically in the other element (cf. MapPatchIntegrationPoint,
    symboliccutbfi.cpp:1116-1199): on simplices the affine map through the
    target cell's Jacobian is exact; on quads/hexes it is the initial guess
    of four Newton steps, and a point that has not converged falls back to
    it.
    """
    f2e = mesh.facet2el_np
    fids = _facet_patch_fids(integral, mesh)
    e1 = torch.as_tensor(f2e[fids, 0], dtype=torch.int64, device=device)
    e2 = torch.as_tensor(f2e[fids, 1], dtype=torch.int64, device=device)
    dtype = config.dtype
    verts, els = mesh.device_view(device, dtype)

    rp, rw = reference_rule(mesh.et, _intorder(integral, order))
    rp = torch.as_tensor(rp, dtype=dtype, device=device)
    rw = torch.as_tensor(rw, dtype=dtype, device=device)
    F, d = len(fids), mesh.dim
    et = mesh.et
    coords1 = verts[els[e1]]
    coords2 = verts[els[e2]]
    base = rp[None]  # (1, nq, d): one rule for every facet
    niter = 4 if et in ("quad", "hex") else 0

    def other_refpts(coords_from, coords_to):
        target, _ = map_points(et, coords_from, base)
        # initial affine guess using the target cell's center Jacobian
        center = torch.full((1, 1, d), 0.5 if et in ("quad", "hex") else 0.25,
                            dtype=dtype, device=device)
        c_phys, Jc = map_points(et, coords_to, center)
        detc, Jcinv = det_and_inv(Jc)
        # "eqg,eodg->eqd"
        xr0 = small_matmul(target - c_phys,
                           Jcinv[:, 0].transpose(-1, -2)) + center
        if niter == 0:
            return xr0
        xr = xr0
        for _ in range(niter):
            p, J = map_points(et, coords_to, xr)
            _, Jinv = det_and_inv(J)
            # "eqg,eqdg->eqd"
            xr = xr + (Jinv * (target - p)[..., None, :]).sum(-1)
        # convergence check + fallback (reference MapPatchIntegrationPoint
        # warns and falls back to a low-order rule on non-convergence,
        # symboliccutbfi.cpp:1184-1199): non-converged points revert to the
        # affine initial guess
        p, _ = map_points(et, coords_to, xr)
        err = torch.linalg.vector_norm(target - p, dim=-1)  # (F, Q)
        h = detc[:, :1].abs() ** (1.0 / d)
        tol = 1e4 * torch.finfo(dtype).eps * h.clamp_min(1e-30)
        return torch.where((err <= tol)[..., None], xr, xr0)

    pts1_in_2 = other_refpts(coords1, coords2)
    pts2_in_1 = other_refpts(coords2, coords1)
    basef = base.expand(F, -1, -1)
    self_pts = torch.cat([basef, pts2_in_1], dim=1)  # on e1
    other_pts = torch.cat([pts1_in_2, basef], dim=1)  # on e2

    ctx = EvalCtx(mesh, self_pts, elem_ids=e1,
                  facet_ids=torch.as_tensor(fids, dtype=torch.int64,
                                            device=device))
    ctx.other_ctx = EvalCtx(mesh, other_pts, elem_ids=e2,
                            facet_ids=ctx.facet_ids)
    det1 = EvalCtx(mesh, base, elem_ids=e1).detJ.abs()
    det2 = EvalCtx(mesh, base, elem_ids=e2).detJ.abs()
    w = torch.cat([(det1 * rw).expand(F, len(rw)),
                   (det2 * rw).expand(F, len(rw))], dim=1)
    return ctx, e1, e2, w, torch.ones_like(w, dtype=torch.bool)


def _facet_locref_tables(mesh):
    """(2, nfacets, nvf, d) element-local reference coordinates of every
    facet's vertices, per side (boundary facets repeat side 0).  Host numpy,
    cached on the mesh."""
    cached = getattr(mesh, "_facet_locref_cache", None)
    if cached is not None:
        return cached
    refv = REF_VERTS[mesh.et]
    f2e = mesh.facet2el_np
    fverts = mesh.facets_np  # (nf, nvf)
    nvf = fverts.shape[1]
    loc_ref = np.zeros((2, mesh.nfacets, nvf, mesh.dim))
    for s in range(2):
        eids = np.where(f2e[:, s] >= 0, f2e[:, s], f2e[:, 0])
        els = mesh.elements_np[eids]  # (nf, nvel)
        for k in range(nvf):
            idx = np.argmax(els == fverts[:, k][:, None], axis=1)
            loc_ref[s, :, k, :] = refv[idx]
    mesh._facet_locref_cache = loc_ref
    return loc_ref


def _facet_param_rule(integral, fet, order, fverts, device):
    """Facet-parametric quadrature of the BND / element-boundary / skeleton
    integrals on R facets with global vertex ids ``fverts`` (R, nvf): the
    plain reference rule, or, under a ``levelset_domain``, the codim-1
    straight-cut rule from the level-set values at the facet corners (its
    IF branch, the codim-2 zero set within the facet, also returns the
    reference normals of that set).  Returns (rp (R,nq,d-1), rw (R,nq),
    nref_if (R,nq,d-1) or None)."""
    dtype = config.dtype
    d1 = ET_DIM[fet]
    R = fverts.shape[0]
    o = _intorder(integral, order)
    ld = integral.levelset_domain
    if ld is None:
        rp, rw = reference_rule(fet, o)
        rp = torch.as_tensor(rp, dtype=dtype, device=device)
        rw = torch.as_tensor(rw, dtype=dtype, device=device)
        return rp[None].expand(R, -1, -1), rw[None].expand(R, -1), None
    dtq = int(ld["domain_type"])
    if dtq not in (int(NEG), int(POS), int(IF)):
        # combined types (HASNEG, ...) would silently zero every weight
        raise ValueError(
            f"facet cut integrals support NEG/POS/IF domain types, got "
            f"{ld['domain_type']!r}")
    lgf = ld["levelset"]
    vdofs = torch.as_tensor(_p1_vertex_dofs(lgf.space), dtype=torch.int64,
                            device=lgf.device)
    fvals = lgf.vec.data[vdofs[fverts.to(lgf.device)]].to(device, dtype)
    split = torch.as_tensor(ET_SPLIT[fet].astype(np.int64), device=device)
    nsplit, nvs = split.shape
    refvf = torch.as_tensor(REF_VERTS[fet], dtype=dtype, device=device)
    fc = refvf[split][None].expand(R, nsplit, nvs, d1).reshape(
        R * nsplit, nvs, d1)
    fvv = eps_guard(fvals[:, split].reshape(R * nsplit, nvs))
    r = cut_rule_simplices(fc, fvv, d1, o)
    if dtq == int(IF):
        # codim 2: points on 2D element boundaries, segments on 3D faces
        # (the reference's unfitted codim-2 branch,
        # xfem/symboliccutbfi.cpp:732, 898-946)
        qi = r.pts_if.shape[1]
        return (r.pts_if.reshape(R, nsplit * qi, d1),
                r.w_if.reshape(R, nsplit * qi),
                r.nref.reshape(R, nsplit * qi, d1))
    qn = r.pts.shape[1]
    return (r.pts.reshape(R, nsplit * qn, d1),
            (r.w * (r.side == dtq)).reshape(R, nsplit * qn), None)


def _facet_measure_normal(tang, nref_if, rw, d):
    """Physical facet weights and unit (unoriented) normal from the facet
    tangents (R,nq,d-1,d); a codim-2 IF rule takes the zero-set tangent
    length (3D) or the counting measure (2D)."""
    if nref_if is not None:
        if d == 2:
            scale = torch.ones_like(rw)
        else:
            that = torch.stack([nref_if[..., 1], -nref_if[..., 0]], dim=-1)
            tvec = small_matmul(that[..., None, :], tang)[..., 0, :]
            scale = torch.linalg.vector_norm(tvec, dim=-1)
    else:
        scale = _gram_measure(tang)
    w = scale * rw
    if d == 2:
        t = tang[:, :, 0, :]
        n = torch.stack([t[..., 1], -t[..., 0]], dim=-1)
    else:
        n = torch.linalg.cross(tang[:, :, 0, :], tang[:, :, 1, :], dim=-1)
    nn = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return w, n / torch.where(nn < 1e-30, 1.0, nn)


def _facet_rows(integral, mesh, order, fverts, row_e, loc_refs, device):
    """Quadrature on R facet rows: the facet rule mapped into the reference
    cell of each ``loc_refs`` side ((R, nvf, d) local vertex coordinates of
    the facet), the physical weights (R, nq) and the unit normal oriented
    away from the centroid of the ``row_e`` element (the outward normal of
    that element).  Returns ([pts per side], w, n)."""
    mesh_fet = FACET_ET[mesh.et]
    rp, rw, nref_if = _facet_param_rule(integral, mesh_fet, order, fverts,
                                        device)
    Nf = geom_shapes(mesh_fet, rp)  # (R, nq, nvf)
    pts = [small_matmul(Nf, lr) for lr in loc_refs]  # "rqk,rkd->rqd"
    verts, els = mesh.device_view(device, rp.dtype)
    pf = verts[fverts]  # (R, nvf, d)
    dNf = geom_dshapes(mesh_fet, rp)  # (R, nq, nvf, d-1)
    tang = small_matmul(dNf.transpose(-1, -2), pf[:, None])  # (R,nq,d-1,d)
    w, n = _facet_measure_normal(tang, nref_if, rw, mesh.dim)
    cent = verts[els[row_e]].mean(1)  # (R, d)
    sign = torch.sign((n * (pf.mean(1) - cent)[:, None, :]).sum(-1))
    n = n * torch.where(sign == 0, 1.0, sign)[..., None]
    return pts, w, n


def _skeleton_ctx(integral: Integral, mesh, order, device):
    """Skeleton quadrature on the selected interior facets, mapped into both
    neighbours (the reference's facet machinery,
    SymbolicFacetBilinearFormIntegrator2, xfem/symboliccutbfi.cpp:948-1102,
    and the cut-facet rule of SymbolicCutFacetBFI, :682-946).  The normal
    points from e1 to e2 and each side sees its own outward normal, so
    ``dnjump`` works on both.  Returns (ctx, e1, e2, w, mask)."""
    fids = _facet_patch_fids(integral, mesh)
    f2e = mesh.facet2el_np
    loc = torch.as_tensor(_facet_locref_tables(mesh)[:, fids],
                          dtype=config.dtype, device=device)
    fverts = torch.as_tensor(mesh.facets_np[fids], dtype=torch.int64,
                             device=device)
    e1 = torch.as_tensor(f2e[fids, 0], dtype=torch.int64, device=device)
    e2 = torch.as_tensor(f2e[fids, 1], dtype=torch.int64, device=device)
    (pts1, pts2), w, n = _facet_rows(integral, mesh, order, fverts, e1,
                                     (loc[0], loc[1]), device)
    fid_t = torch.as_tensor(fids, dtype=torch.int64, device=device)
    ctx = EvalCtx(mesh, pts1, elem_ids=e1, normal=n, facet_ids=fid_t)
    ctx.other_ctx = EvalCtx(mesh, pts2, elem_ids=e2, normal=-n,
                            facet_ids=fid_t)
    return ctx, e1, e2, w, w > 0


def _element_boundary_ctx(integral: Integral, mesh, order, device):
    """Quadrature on every local facet of the selected elements, one-sided
    (the reference's T_CalcElementMatrixEBAdd,
    xfem/symboliccutbfi.cpp:319, 491-678): rows are (element, local facet)
    pairs, element-major; trial and test factors live on the row's element
    and the normal is its outward one.  Returns (ctx, row_e, w, mask)."""
    fv_loc = np.array(FACET_VERTS[mesh.et], dtype=np.int64)  # (nfel, nvf)
    nfel = fv_loc.shape[0]
    elems = (np.arange(mesh.ne) if integral.definedonelements is None
             else np.nonzero(integral.definedonelements)[0])
    rows_e = np.repeat(elems, nfel)
    lf = np.tile(np.arange(nfel), len(elems))
    fverts = torch.as_tensor(mesh.elements_np[rows_e[:, None], fv_loc[lf]],
                             dtype=torch.int64, device=device)
    loc = torch.as_tensor(REF_VERTS[mesh.et][fv_loc[lf]],
                          dtype=config.dtype, device=device)
    row_e = torch.as_tensor(rows_e, dtype=torch.int64, device=device)
    (pts,), w, n = _facet_rows(integral, mesh, order, fverts, row_e, (loc,),
                               device)
    fid = torch.as_tensor(mesh.el2facet_np[rows_e, lf], dtype=torch.int64,
                          device=device)
    ctx = EvalCtx(mesh, pts, elem_ids=row_e, normal=n, facet_ids=fid)
    return ctx, row_e, w, w > 0


def _bnd_mask_np(integral: Integral, mesh):
    """Per-boundary-facet selection of a BND integral (host numpy): a mask
    over boundary facets (the BND-element reading) or over volume elements
    (through adjacency)."""
    sel = np.asarray(integral.definedonelements)
    bf = mesh.boundary_facets_np
    if len(sel) == len(bf):
        if len(bf) == mesh.ne:
            warnings.warn(
                "BND definedonelements length matches BOTH the boundary-"
                "facet and volume-element counts; interpreting it as a "
                "boundary-element mask (pass a volume mask of a finer mesh "
                "to disambiguate)")
        return sel
    if len(sel) == mesh.ne:
        return sel[mesh.facet2el_np[bf, 0]]
    raise ValueError(
        "definedonelements for a BND integral must mask boundary "
        f"elements ({len(bf)}) or volume elements ({mesh.ne})")


def _boundary_ctx(integral: Integral, mesh, order, device):
    """Quadrature on the selected boundary facets ("BND elements", the
    reference's CutInformation BND loop, xfem/cutinfo.cpp:54-188): one row
    per facet, factors on the adjacent volume element, outward boundary
    normal; under a level-set domain a codim-1 cut rule on each facet.
    Returns (ctx, row_e, w, mask)."""
    bf = mesh.boundary_facets_np
    if integral.definedonelements is not None:
        bf = bf[_bnd_mask_np(integral, mesh)]
    rows_e = mesh.facet2el_np[bf, 0]
    fverts = torch.as_tensor(mesh.facets_np[bf], dtype=torch.int64,
                             device=device)
    loc = torch.as_tensor(_facet_locref_tables(mesh)[0][bf],
                          dtype=config.dtype, device=device)
    row_e = torch.as_tensor(rows_e, dtype=torch.int64, device=device)
    (pts,), w, n = _facet_rows(integral, mesh, order, fverts, row_e, (loc,),
                               device)
    ctx = EvalCtx(mesh, pts, elem_ids=row_e, normal=n,
                  facet_ids=torch.as_tensor(bf, dtype=torch.int64,
                                            device=device))
    return ctx, row_e, w, w > 0


def _check_proxy_spaces(form, space_u, space_v):
    """Every trial proxy in the form must come from the trial space and every
    test proxy from the test space — with a rectangular BilinearForm a proxy
    from a third space would silently scatter through the wrong dof map."""

    def root(p):
        return p.compound[0] if p.compound is not None else p.space

    def walk(cf):
        if isinstance(cf, ProxyFunction):
            want = space_v if cf.test else space_u
            if root(cf) is not want:
                kind = "test" if cf.test else "trial"
                raise ValueError(
                    f"{kind} function in the form does not belong to the "
                    f"declared {kind} space of this BilinearForm")
        if isinstance(cf, CF):
            for c in cf.children():
                walk(c)

    walk(form)


def _form_difforders(form):
    """Minimum spatial derivative order of the form's trial and test proxies
    (reference: ``SymbolicCutBFI`` reduces the cut-rule order by these on
    simplices, ``xfem/symboliccutbfi.cpp:96-107``).  Unknown ops count as 0
    (no reduction — conservative)."""

    def dord(p):
        if p.op == "dnk":
            return int(p.op_args[0])
        return 1 if p.op in ("grad", "div") or p.op.endswith("grad") else 0

    tr = te = 99

    def walk(cf):
        nonlocal tr, te
        if isinstance(cf, ProxyFunction):
            if cf.test:
                te = min(te, dord(cf))
            else:
                tr = min(tr, dord(cf))
        if isinstance(cf, CF):
            for c in cf.children():
                walk(c)

    walk(form)
    return (0 if tr == 99 else tr), (0 if te == 99 else te)


def _bfi_intorder(integral, mesh, space_u, space_v):
    """Volume-BFI integration order: trial + test space order, reduced on
    simplex elements by the minimum derivative order of the form's trial
    and test proxies — the reference's rule (``symboliccutbfi.cpp:96-107``).
    E.g. P1 ``grad(u)*grad(v)`` has a piecewise-constant integrand, so the
    cut tier only needs the order-0 (measure) rule.  ``force_intorder``
    overrides downstream."""
    o = _space_order(space_u) + _space_order(space_v)
    if mesh.et in ("trig", "tet"):
        tr, te = _form_difforders(integral.form)
        o = max(0, o - tr - te)
    return o


def _msk(arr, mask):
    """Zero a factor array at padded quadrature points (NaN-safe: singular
    coefficients absorbed into factors must not poison 0-weight points)."""
    m = mask.reshape(tuple(mask.shape) + (1,) * (arr.ndim - 2))
    return torch.where(m, arr, 0.0)


def _term_cfree_scalar(term, W):
    """Fold a FREE coefficient factor into the scalar weight; a free factor
    with vector/matrix components left over means the integrand is not
    scalar — raise instead of silently dropping it."""
    if term.cfree is None:
        return torch.broadcast_to(term.scalar, W.shape)
    if tuple(term.cfree.shape[2:]) != ():
        raise TypeError(
            "non-scalar integrand: a coefficient factor with free components "
            f"{tuple(term.cfree.shape[2:])} is not contracted with the "
            "trial/test functions")
    return torch.broadcast_to(term.scalar, W.shape) * term.cfree


def _term_elmat(term, W, mask):
    """Element matrices (E, ndv, ndu) of one u&v term; W = (E,Q) weights."""
    s = _term_cfree_scalar(term, W)
    Wts = W * torch.where(mask, s, 0.0)  # NaN-safe on padded points
    u, v = _msk(term.ufac.arr, mask), _msk(term.vfac.arr, mask)
    E = W.shape[0]
    if term.contracted:
        # "eq,eqjk,eqik->eji": fold the component axis into the point axis.
        # The point contraction is a multiply-sum (a batch of tiny matmuls
        # runs as a library GEMM on the card, slower than elementwise work).
        Q, X = W.shape[1], v.shape[3]
        wv = Wts[..., None, None] * v  # (E,Q,ndv,X)
        a = wv.permute(0, 2, 1, 3).reshape(E, v.shape[2], Q * X)
        b = u.permute(0, 1, 3, 2).reshape(E, Q * X, u.shape[2])
        return small_matmul(a, b)
    if u.ndim != 3 or v.ndim != 3:
        raise TypeError("non-scalar integrand in bilinear form")
    # "eq,eqj,eqi->eji"
    return small_matmul((Wts[..., None] * v).transpose(-1, -2), u)


def _term_elvec(term, W, mask):
    s = _term_cfree_scalar(term, W)
    Wts = W * torch.where(mask, s, 0.0)
    v = _msk(term.vfac.arr, mask)
    if v.ndim != 3:
        raise TypeError("non-scalar integrand in linear form")
    return (Wts[..., None] * v).sum(1)  # "eq,eqj->ej"


def _safe_weights(w_phys, mask):
    """zero weights exactly where masked (NaN-safe: scalars are multiplied
    after masking)."""
    return torch.where(mask, w_phys, 0.0)


class BilinearForm:
    """Square (one ``space``) or rectangular Petrov-Galerkin
    (``trialspace=``/``testspace=``) bilinear form.  Rectangular: rows are
    test-space dofs, columns trial-space dofs;
    ``mat.shape = (testspace.ndof, trialspace.ndof)``.  ``Assemble`` runs
    on the device of the space (the card unless the space was given
    ``device="cpu"``)."""

    def __init__(self, space=None, symmetric=False, check_unused=True,
                 element_restriction=None, facet_restriction=None, flags=None,
                 name="a", trialspace=None, testspace=None, **kw):
        if (trialspace is None) != (testspace is None):
            raise ValueError(
                "give both trialspace and testspace (or a single space)")
        if trialspace is not None:
            if space is not None:
                raise ValueError(
                    "either space or trialspace/testspace, not both")
            if trialspace.mesh is not testspace.mesh:
                raise ValueError(
                    "trial and test space must live on the same mesh")
            self.space_u, self.space_v = trialspace, testspace
            space = trialspace
        else:
            if space is None:
                raise ValueError("BilinearForm needs a space")
            self.space_u = self.space_v = space
        self.space = space
        self.symmetric = symmetric
        self.integrals = []
        self.element_restriction = element_restriction
        self.facet_restriction = facet_restriction
        self.mat = None

    def __iadd__(self, integral: Integral):
        if not isinstance(integral, Integral):
            raise TypeError("add SymbolicBFI(...) objects")
        self.integrals.append(integral)
        return self

    def Assemble(self, reallocate=False, heapsize=None):
        space_u, space_v = self.space_u, self.space_v
        mesh = self.space.mesh
        device = self.space.device
        order = max(_space_order(space_u), _space_order(space_v))
        if not self.integrals:
            raise ValueError("no integrals to assemble")
        for i in self.integrals:
            _ensure_p1_ld(i, mesh, device)
            _check_proxy_spaces(i.form, space_u, space_v)
        vparts, rparts, cparts = [], [], []
        for integral in map(self._with_restriction, self.integrals):
            if integral.facet_patch or integral.skeleton:
                build = (_facet_patch_ctx if integral.facet_patch
                         else _skeleton_ctx)
                ctx, e1, e2, w_phys, mask = build(integral, mesh, 2 * order,
                                                  device)
                tiers = [(ctx, w_phys, mask, (e1, e2))]
            elif integral.element_boundary or integral.vb == BND:
                build = (_element_boundary_ctx if integral.element_boundary
                         else _boundary_ctx)
                ctx, row_e, w_phys, mask = build(integral, mesh, 2 * order,
                                                 device)
                tiers = [(ctx, w_phys, mask, (row_e, row_e))]
            else:
                tiers = [(ctx, w, mask, (ids, None)) for ctx, w, mask, ids
                         in _volume_tiers(
                             integral, mesh,
                             _bfi_intorder(integral, mesh, space_u, space_v),
                             device)]
            for tctx, w_phys, mask, (es, eo) in tiers:
                # terms accumulate per (trial, test) block pair
                acc = {}
                W = _safe_weights(w_phys, mask)
                for t in eval_form(integral.form, tctx):
                    if t.ufac is None and t.vfac is None:
                        raise TypeError(
                            "bilinear form has a term with neither trial "
                            "nor test function (a constant added to the "
                            "integrand?)")
                    if t.ufac is None or t.vfac is None:
                        raise TypeError(
                            "bilinear form term missing trial or test factor")
                    m = _term_elmat(t, W, mask)
                    key = (t.ufac.block, t.vfac.block)
                    acc[key] = m if key not in acc else acc[key] + m
                for (bu, bv), m in acc.items():
                    dm_u = block_dofmap(space_u, bu, es, eo, device=device)
                    dm_v = block_dofmap(space_v, bv, es, eo, device=device)
                    rows = dm_v[:, :, None].expand(m.shape)
                    cols = dm_u[:, None, :].expand(m.shape)
                    # triplets at placeholder slots are left out: they hold
                    # zeros (their factors are masked, or their elements lie
                    # outside the integral's selection) and would otherwise
                    # all land in the placeholder's row and column
                    vu = block_valid(space_u, bu, es, eo, device=device)
                    vv = block_valid(space_v, bv, es, eo, device=device)
                    if vu is not None or vv is not None:
                        keep = torch.ones_like(m, dtype=torch.bool)
                        if vv is not None:
                            keep = keep & vv[:, :, None]
                        if vu is not None:
                            keep = keep & vu[:, None, :]
                        m, rows, cols = m[keep], rows[keep], cols[keep]
                    vparts.append(m.reshape(-1))
                    rparts.append(rows.reshape(-1))
                    cparts.append(cols.reshape(-1))
        self.mat = SparseMatrix(torch.cat(rparts), torch.cat(cparts),
                                torch.cat(vparts),
                                (space_v.ndof, space_u.ndof), device=device)
        return self

    def AssembleOperator(self, lattice="auto"):
        raise NotImplementedError(
            "AssembleOperator (matrix-free operators) is not ported yet "
            "(ROADMAP A10)")

    def _with_restriction(self, integral: Integral):
        """Apply the form-level restrictions (RestrictedBilinearForm,
        utils/restrictedblf.hpp:7-30): element_restriction to element-row
        integrals, facet_restriction to facet-row (skeleton and facet-patch)
        integrals.  An integral's own definedonelements wins."""
        facet_rows = integral.facet_patch or integral.skeleton
        restriction = (self.facet_restriction if facet_rows
                       else self.element_restriction)
        if restriction is None or integral.definedonelements is not None:
            return integral
        ii = copy.copy(integral)
        ii.definedonelements = _arr(restriction).copy()
        return ii

    def Apply(self, x):
        return self.mat * x


class LinearForm:
    """Linear form of volume and boundary integrals; ``Assemble`` runs on
    the device of the space and leaves the vector there (``f.vec.data``).
    Its element vectors are added in one fixed order (``ops.scatter``), so
    the vector is the same on every run, on the CPU and on the card.  The
    plan of that order is kept for the next ``Assemble`` that gives the
    same dof stream."""

    def __init__(self, space, name="f", **kw):
        self.space = space
        self.integrals = []
        self._vec = None
        self._plan = None  # (dof stream, its ScatterPlan)

    def __iadd__(self, integral: Integral):
        self.integrals.append(integral)
        return self

    @property
    def vec(self):
        from ..fem.gridfunction import StandaloneVec

        return StandaloneVec(self._vec)

    def Assemble(self, heapsize=None):
        space = self.space
        mesh = space.mesh
        device = space.device
        order = _space_order(space)
        dofs, contribs = [], []
        for integral in self.integrals:
            _ensure_p1_ld(integral, mesh, device)
            if (integral.element_boundary or integral.skeleton
                    or integral.facet_patch):
                # the reference SymbolicCutLFI also throws for these
                # (xfem/symboliccutlfi.cpp:51-160)
                raise NotImplementedError(
                    "LinearForm supports volume and BND integrals only")
            if integral.vb == BND:
                ctx, row_e, w_phys, mask = _boundary_ctx(
                    integral, mesh, 2 * order + mesh.dim, device)
                tiers = [(ctx, w_phys, mask, row_e)]
            else:
                tiers = _volume_tiers(integral, mesh, 2 * order + mesh.dim,
                                      device)
            for tctx, w_phys, mask, ids in tiers:
                W = _safe_weights(w_phys, mask)
                for t in eval_form(integral.form, tctx):
                    if t.ufac is None and t.vfac is None:
                        raise TypeError(
                            "linear form has a term with no test function "
                            "(a constant added to the integrand?)")
                    if t.vfac is None or t.ufac is not None:
                        raise TypeError(
                            "linear form must be linear in the test function")
                    ve = _term_elvec(t, W, mask).to(config.dtype).reshape(-1)
                    dm_v = block_dofmap(space, t.vfac.block, ids,
                                        device=device).reshape(-1)
                    # placeholder slots hold zeros and would all land on one
                    # dof (as in BilinearForm.Assemble): left out
                    vv = block_valid(space, t.vfac.block, ids, device=device)
                    if vv is not None:
                        keep = vv.reshape(-1)
                        dm_v, ve = dm_v[keep], ve[keep]
                    dofs.append(dm_v)
                    contribs.append(ve)
        out = torch.zeros(space.ndof, dtype=config.dtype, device=device)
        if dofs:
            index = torch.cat(dofs)
            hit = self._plan
            if (hit is None or hit[0].shape != index.shape
                    or hit[0].device != index.device
                    or not torch.equal(hit[0], index)):
                hit = self._plan = (index, ScatterPlan(index, space.ndof))
            hit[1].add(torch.cat(contribs), out)
        self._vec = out
        return self


def RestrictedBilinearForm(space, name="a", element_restriction=None,
                           facet_restriction=None, check_unused=False, flags=None,
                           **kw):
    """BilinearForm whose sparsity is restricted to marked elements/facets
    (utils/restrictedblf.hpp:7-30) — with COO assembly the restriction is the
    assembly mask itself."""
    return BilinearForm(space, element_restriction=element_restriction,
                        facet_restriction=facet_restriction,
                        check_unused=check_unused, flags=flags, name=name)
