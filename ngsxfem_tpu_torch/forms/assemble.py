"""Integrals, BilinearForm/LinearForm and batched assembly.

Counterpart of ``ngsxfem_tpu/forms/assemble.py`` (the replacement for the
reference's symbolic cut integrators, ``xfem/symboliccutbfi.*``,
``xfem/symboliccutlfi.*``, ``utils/restrictedblf.*``): each integral is
assembled for all (marked) elements at once — cut-rule tensors -> jet
evaluation -> one contraction per term -> COO scatter.  Sparsity
restriction (RestrictedBilinearForm) is implicit: only assembled entries
exist.

Ported: volume integrals (with or without a level-set domain, two quadrature
tiers as ``integrate.two_tier_tiers`` builds them) and facet-patch integrals
on scalar spaces, their ``Compress``ed restrictions and compounds of them.
The assembly is eager and takes every selection exactly, so the reference's
per-signature program cache and its capacity-padded dynamic selections have
no counterpart.  The COO rows and columns are gathered on the device from
the space's dof map; the values never leave it.  Not ported, each raising
``NotImplementedError``: ``skeleton=True``, ``element_boundary=True`` and
``VOL_or_BND=BND`` (ROADMAP A9b), ``time_order >= 0`` (A13),
``deformation`` (A11), ``subdivlvl > 0`` (A8b) and ``AssembleOperator``
(A10).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..config import config
from ..cf.coefficient import CF, wrap
from ..cf.context import EvalCtx
from ..integrate import (ensure_p1_levelset, normalize_levelset_domain,
                         two_tier_tiers)
from ..mesh.mesh import det_and_inv, map_points, small_matmul
from ..ops.gauss import reference_rule
from ..fem.space import CompoundFESpace, _arr
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
        if vb == BND:
            raise NotImplementedError(
                "VOL_or_BND=BND integrals are not ported yet (ROADMAP A9b)")
        if skeleton:
            raise NotImplementedError(
                "skeleton=True facet integrals are not ported yet "
                "(ROADMAP A9b)")
        if element_boundary:
            raise NotImplementedError(
                "element_boundary=True integrals are not ported yet "
                "(ROADMAP A9b)")
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
    e2d = sp.el2dof_on(device)
    eids = elem_ids_other if other else elem_ids_self
    if eids is not None:
        e2d = e2d[eids]
    return e2d + _block_offset(space, blk)


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
    """Selected interior facets of a facet-patch integral (host numpy)."""
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
        return 1 if p.op == "grad" else 0

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
            if integral.facet_patch:
                ctx, e1, e2, w_phys, mask = _facet_patch_ctx(
                    integral, mesh, 2 * order, device)
                tiers = [(ctx, w_phys, mask, (e1, e2))]
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
                    vparts.append(m.reshape(-1))
                    rparts.append(dm_v[:, :, None].expand(m.shape).reshape(-1))
                    cparts.append(dm_u[:, None, :].expand(m.shape).reshape(-1))
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
        integrals, facet_restriction to facet-patch integrals.  An
        integral's own definedonelements wins."""
        restriction = (self.facet_restriction if integral.facet_patch
                       else self.element_restriction)
        if restriction is None or integral.definedonelements is not None:
            return integral
        ii = copy.copy(integral)
        ii.definedonelements = _arr(restriction).copy()
        return ii

    def Apply(self, x):
        return self.mat * x


class LinearForm:
    """Linear form of volume integrals; ``Assemble`` runs on the device of
    the space and leaves the vector there (``f.vec.data``)."""

    def __init__(self, space, name="f", **kw):
        self.space = space
        self.integrals = []
        self._vec = None

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
        out = torch.zeros(space.ndof, dtype=config.dtype, device=device)
        for integral in self.integrals:
            _ensure_p1_ld(integral, mesh, device)
            if integral.facet_patch:
                # the reference SymbolicCutLFI also throws for these
                # (xfem/symboliccutlfi.cpp:51-160)
                raise NotImplementedError(
                    "LinearForm supports volume integrals only")
            for tctx, w_phys, mask, ids in _volume_tiers(
                    integral, mesh, 2 * order + mesh.dim, device):
                W = _safe_weights(w_phys, mask)
                for t in eval_form(integral.form, tctx):
                    if t.ufac is None and t.vfac is None:
                        raise TypeError(
                            "linear form has a term with no test function "
                            "(a constant added to the integrand?)")
                    if t.vfac is None or t.ufac is not None:
                        raise TypeError(
                            "linear form must be linear in the test function")
                    ve = _term_elvec(t, W, mask)
                    dm_v = block_dofmap(space, t.vfac.block, ids,
                                        device=device)
                    out.index_add_(0, dm_v.reshape(-1),
                                   ve.to(out.dtype).reshape(-1))
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
