"""Isoparametric level-set mesh deformation ("lsetcurving").

Counterpart of ``ngsxfem_tpu/lsetcurv/lsetcurv.py`` (the reference's
geometry high-order layer ``lsetcurving/``: ProjectShift
``projshift.cpp:8-173``, point search ``calcpointshift.hpp:48-57``, driver
class ``lsetcurv.py:9-203``): the mesh deformation psi maps the
piecewise-linear level-set zero set onto the high-order one.  The spaces are
nodal, so the shift is computed directly at the Lagrange nodes of the
deformation space by a batched Newton search along qn = grad(lset_ho), with
polynomial extension of the element basis.  The search runs eagerly on the
device of the level-set GridFunctions, with a fixed count of iterations and
no program cache.
"""
from __future__ import annotations

import numbers
import warnings
from math import sqrt as msqrt

import numpy as np
import torch

from ..fem.basis import dshapes, shapes
from ..fem.gridfunction import GridFunction, InterpolateToP1
from ..fem.space import H1, Periodic, VectorFESpace, VectorH1
from ..integrate import lset_vertex_values, two_tier_tiers, vertex_local_ids
from ..mesh.mesh import det_and_inv, geom_shapes, map_points
from ..ops.straightcut import eps_guard
from ..utils.diagnostics import NewtonNonConvergenceWarning
from ..utils.timing import Timer, count, traced

_NEWTON_TOL = 1e-6  # max |phi - goal| / h on the band before a warning


def _project_shift(mesh, order, threshold, ho_vec, ho_el2dof, p1_vec,
                   p1_el2dof, rep_e, rep_p, d_el2dof, band, alpha, niter=8):
    """Nodal shift of the deformation space's dofs.

    ``ho_vec``/``ho_el2dof``: the order-``order`` level set and its space's
    element map (the gather); ``p1_vec``/``p1_el2dof``: the P1 level set;
    ``rep_e``/``rep_p`` (nd,), (nd, d): a representative element and
    reference point of each scalar dof of the deformation space, whose
    element map ``d_el2dof`` spreads the element ``band`` (ne,) bool onto
    the active dofs; ``alpha`` (nd,) the blending value at each node
    (reference blending CF, lsetcurv.py:118-152).  Returns (deformation dof
    vector in the block layout ``[comp0; comp1; ...]``, max over the band
    of the Newton residual |phi - goal| / h); the residual drives the
    non-convergence warning (the reference's SearchCorrespondingPoint warns,
    symboliccutbfi.cpp:1184-1192).
    """
    et = mesh.et
    d = mesh.dim
    dev, dt = ho_vec.device, ho_vec.dtype
    verts, els = mesh.device_view(dev, dt)
    vperm = torch.as_tensor(vertex_local_ids(et, 1), dtype=torch.int64,
                            device=dev)
    coords = verts[els[rep_e]]  # (nd, nv, d)
    pts = rep_p[:, None, :]  # (nd, 1, d)
    _, J = map_points(et, coords, pts)
    detJ, Jinv = det_and_inv(J)
    Jinv = Jinv[:, 0]  # (nd, d, d)
    h = detJ[:, 0].abs() ** (1.0 / d)

    ho_dofs = ho_vec[ho_el2dof[rep_e]]  # (nd, ndl)

    def phi_and_grad(ref):
        val = (shapes(et, order, ref)[:, 0] * ho_dofs).sum(-1)
        gref = (dshapes(et, order, ref)[:, 0] * ho_dofs[..., None]).sum(-2)
        return val, gref

    # search direction: the physical gradient at the node ("nd,ndg->ng"),
    # pulled back to the reference cell ("ndg,ng->nd")
    phi0, gref0 = phi_and_grad(pts)
    q_phys = (gref0[..., None] * Jinv).sum(-2)
    q_ref = (Jinv * q_phys[:, None, :]).sum(-1)

    # goal value: (1 - alpha) * phi_p1 + alpha * phi_ho at the node
    p1_dofs = p1_vec[p1_el2dof[rep_e][:, vperm]]  # (nd, nvel)
    phi_p1 = (geom_shapes(et, rep_p) * p1_dofs).sum(-1)
    goal = (1.0 - alpha) * phi_p1 + alpha * phi0

    t = torch.zeros_like(phi0)
    for _ in range(niter):
        val, gref = phi_and_grad(pts + (t[:, None] * q_ref)[:, None, :])
        dphi = (gref * q_ref).sum(-1)
        dphi = torch.where(dphi.abs() < 1e-30, 1.0, dphi)
        t = t - (val - goal) / dphi

    # displacement, clamped to threshold * h (ref. shiftintegrators.cpp:107)
    disp = t[:, None] * q_phys  # (nd, d)
    if threshold >= 0:
        dn = torch.linalg.vector_norm(disp, dim=1)
        lim = threshold * h
        scale = torch.where(dn > lim, lim / torch.where(dn < 1e-30, 1.0, dn),
                            1.0)
        disp = disp * scale[:, None]

    # restrict to the band of marked elements: the union of their scalar
    # dofs (a scatter-max of the marks, written as a fill of the marked
    # elements' dofs: the same set, and deterministic)
    active = torch.zeros(rep_e.shape[0], dtype=torch.bool, device=dev)
    active.index_fill_(0, d_el2dof[band].reshape(-1), True)
    disp = torch.where(active[:, None], disp, 0.0)

    # Newton convergence diagnostic on the active band
    val_fin, _ = phi_and_grad(pts + (t[:, None] * q_ref)[:, None, :])
    res = torch.where(active, (val_fin - goal).abs() / h.clamp_min(1e-30),
                      0.0)
    return disp.T.reshape(-1), res.max() if res.numel() else res.sum()


class LevelSetMeshAdaptation:
    """User-facing driver (cf. reference lsetcurving/lsetcurv.py:9-203).
    Its spaces and GridFunctions live on ``device`` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, mesh, order=2, lset_lower_bound=0, lset_upper_bound=0,
                 threshold=1.0, discontinuous_qn=True, heapsize=None,
                 periodic=False, device=None):
        self.mesh = mesh
        self.order = order
        self.threshold = threshold
        self.periodic = bool(periodic)
        self.ho_space = H1(mesh, order=order, device=device)
        self.p1_space = H1(mesh, order=1, device=device)
        if self.periodic:
            # one Newton shift for both copies of a dof on the periodic
            # seam (the reference wraps v_def in Periodic,
            # spacetime/lset_spacetime.py:51-52)
            self.deform_space = VectorFESpace(
                Periodic(H1(mesh, order=order, device=device)))
        else:
            self.deform_space = VectorH1(mesh, order=order, device=device)
        self.lset_ho = GridFunction(self.ho_space, "lset_ho")
        self.lset_p1 = GridFunction(self.p1_space, "lset_p1")
        self.deform = GridFunction(self.deform_space, "deform")
        self.levelset = None

    @traced("LevelSetMeshAdaptation::CalcDeformation")
    def CalcDeformation(self, levelset, blending=None, **kw):
        """Compute lset_ho, lset_p1 and the isoparametric deformation."""
        self.levelset = levelset
        self.lset_ho.Set(levelset)
        InterpolateToP1(self.lset_ho, self.lset_p1)
        return self._shift_from_nodal(self.lset_ho, self.lset_p1, self.deform,
                                      blending=blending)

    def _blending_alpha(self, lset_p1, blending):
        """Pointwise blending values at the deformation dof nodes
        (reference blending options, lsetcurving/lsetcurv.py:118-152)."""
        from ..cf.coefficient import specialcf, wrap
        from ..cf.context import EvalCtx, eval_pure

        dscal = self.deform_space.scalar
        dev, dt = self.deform.device, self.deform.dtype
        if blending is None or (isinstance(blending, str)
                                and blending == "none"):
            return torch.zeros(len(dscal.dof_rep_elem), dtype=dt, device=dev)
        if isinstance(blending, str):
            scale = msqrt(self.mesh.dim) * specialcf.mesh_size
            if blending == "quadratic":
                blending = lset_p1 * lset_p1 / (scale * scale)
            elif blending == "quartic":
                blending = (lset_p1 * lset_p1 * lset_p1 * lset_p1
                            / (scale * scale * scale * scale))
            else:
                raise ValueError(f"unknown blending {blending!r}")
        elif isinstance(blending, numbers.Number):
            blending = wrap(float(blending))
        rep_e = torch.as_tensor(dscal.dof_rep_elem, dtype=torch.int64,
                                device=dev)
        rep_p = torch.as_tensor(dscal.dof_rep_ref, dtype=dt,
                                device=dev)[:, None, :]
        ctx = EvalCtx(self.mesh, rep_p, elem_ids=rep_e)
        a = torch.broadcast_to(eval_pure(wrap(blending), ctx),
                               (rep_p.shape[0], 1))[:, 0]
        return a.clamp(0.0, 1.0)

    def _shift_from_nodal(self, lset_ho, lset_p1, deform, blending=None,
                          band=None):
        """ProjectShift step for given nodal lset_ho/lset_p1 GridFunctions;
        ``band`` (ne,) bool optionally overrides the active element set
        (default: the elements the P1 level set cuts)."""
        dev = deform.device
        if band is None:
            # absolute sign-collapsing zero guard (ops eps_guard, reference
            # straightcutrule.cpp:553-554)
            vv = eps_guard(lset_vertex_values(lset_p1))
            band = (vv < 0).any(1) & (vv > 0).any(1)
        band = torch.as_tensor(band, dtype=torch.bool, device=dev)
        alpha = self._blending_alpha(lset_p1, blending)
        dscal = self.deform_space.scalar
        i64 = dict(dtype=torch.int64, device=dev)
        with Timer("ProjectShift", block=False):
            # every node of the deformation space takes the Newton search
            count("ProjectShift::nodes", len(dscal.dof_rep_elem))
            vec, res = _project_shift(
                self.mesh, self.order, self.threshold,
                lset_ho.vec.data.to(dev, deform.dtype),
                self.ho_space.el2dof_on(dev),
                lset_p1.vec.data.to(dev, deform.dtype),
                self.p1_space.el2dof_on(dev),
                torch.as_tensor(dscal.dof_rep_elem, **i64),
                torch.as_tensor(dscal.dof_rep_ref, dtype=deform.dtype,
                                device=dev),
                dscal.el2dof_on(dev), band, alpha)
            res = float(res)
        if res > _NEWTON_TOL:
            warnings.warn(
                f"isoparametric shift Newton did not fully converge "
                f"(max |phi-goal|/h = {res:.2e}); the deformation is "
                f"threshold-clamped but may be less accurate (cf. reference "
                f"warning + fallback, symboliccutbfi.cpp:1184-1192)",
                NewtonNonConvergenceWarning)
        deform._set_array(vec)
        return deform

    def _interface_values(self, levelset, deform, order):
        """(|levelset| (R, Q), interface weights (R, Q), element ids (R,))
        at the IF rule of the deformed P1 zero set, on the cut elements only
        (the uncut elements carry zero interface weight)."""
        from ..cf.coefficient import wrap
        from ..cf.context import eval_pure
        from ..domaintype import IF

        lv = wrap(levelset if levelset is not None else self.levelset)
        self.mesh.SetDeformation(self.deform if deform is None else deform)
        try:
            (ctx, w_phys, mask, ids), = two_tier_tiers(
                self.mesh, self.lset_p1, int(IF), order, "OPTIMAL")
            vals = torch.broadcast_to(eval_pure(lv, ctx), w_phys.shape).abs()
            return torch.where(w_phys > 0, vals, 0.0), w_phys, ids
        finally:
            self.mesh.UnsetDeformation()

    def CalcMaxDistance(self, levelset=None, deform=None, heapsize=None,
                        order=None):
        """max |phi| over the deformed P1 zero set — the geometric distance
        estimate (cf. lsetcurving/calcgeomerrors.cpp; agrees with the true
        distance to first order when ||grad phi|| ~ 1 near the
        interface)."""
        o = order if order is not None else 2 * self.order
        vals, _, _ = self._interface_values(levelset, deform, o)
        return float(vals.max()) if vals.numel() else 0.0

    def ProjectOnUpdate(self, gfs):
        pass

    def CalcDistances(self, levelset=None, order=None, stats=None):
        """Distance statistics of the deformed P1 zero set (cf. reference
        CalcDistances, lsetcurving/calcgeomerrors.cpp): returns
        (max, L1-mean, L2) of |phi| over the interface; with a
        StatisticContainer ``stats``, appends the series
        ("max"/"L1"/"L2")."""
        o = order if order is not None else 2 * self.order
        vals, w, _ = self._interface_values(levelset, None, o)
        tot = w.sum()
        mx = float(vals.max())
        l1 = float((vals * w).sum() / tot)
        l2 = float(torch.sqrt((vals * vals * w).sum() / tot))
        if stats is not None:
            stats.Add("max", mx)
            stats.Add("L1", l1)
            stats.Add("L2", l2)
        return mx, l1, l2

    def MarkForRefinement(self, levelset=None, refine_threshold=0.1,
                          absolute=False):
        """Mark the elements whose interface geometry error (max |phi| over
        the element's part of the deformed P1 zero set) exceeds the
        threshold, relative to the largest unless ``absolute``, for the next
        mesh.Refine() (reference lsetcurv.py MarkForRefinement /
        CalcDistances refinement flags, lsetcurving/calcgeomerrors.cpp)."""
        from ..fem.space import BitArray

        vals, _, ids = self._interface_values(levelset, None, 2 * self.order)
        per_el = np.zeros(self.mesh.ne)
        if vals.numel():
            per_el[ids.cpu().numpy()] = vals.max(1).values.cpu().numpy()
        thresh = (refine_threshold if absolute
                  else refine_threshold * max(per_el.max(), 1e-300))
        marks = per_el > thresh
        self.mesh.SetRefinementFlags(marks)
        return BitArray(marks)


def RefineAtLevelSet(gf, lower=0.0, upper=0.0):
    """Mark the elements cut by (or within [lower, upper] of) the level set
    for the next mesh.Refine() (reference lsetcurving/lsetrefine.cpp:13-42:
    an element is marked iff min(phi_vertices) <= upper and max >=
    lower)."""
    from ..fem.space import BitArray

    vals = lset_vertex_values(gf)
    marks = ((vals.min(1).values <= upper)
             & (vals.max(1).values >= lower)).cpu().numpy()
    gf.space.mesh.SetRefinementFlags(marks)
    return BitArray(marks)


def _adapter_from_gfs(lset_ho, lset_p1, deform, threshold=1.0):
    """Internal: wrap existing GridFunctions in a LevelSetMeshAdaptation
    shell so the free-function bindings (reference
    lsetcurving/python_lsetcurving.cpp ProjectShift/CalcMaxDistance/
    CalcDistances) can reuse the class methods."""
    self = LevelSetMeshAdaptation.__new__(LevelSetMeshAdaptation)
    self.mesh = lset_ho.space.mesh
    self.order = lset_ho.space.order
    self.threshold = threshold
    self.ho_space = lset_ho.space
    self.p1_space = lset_p1.space
    self.deform_space = deform.space if deform is not None else None
    self.lset_ho = lset_ho
    self.lset_p1 = lset_p1
    self.deform = deform
    self.levelset = lset_ho
    return self


def ProjectShift(lset_ho, lset_p1, deform, qn=None, active_elements=None,
                 blending=None, lower=0.0, upper=0.0, threshold=1.0,
                 heapsize=None):
    """Free-function shift projection (reference
    lsetcurving/python_lsetcurving.cpp:125-136, projshift.cpp:8-173):
    writes into ``deform`` the nodal shift mapping the lset_p1 zero set onto
    the lset_ho one.  ``qn`` (the quasi-normal CF) is unused: the batched
    Newton search takes its direction from grad(lset_ho) directly.
    [lower, upper] widen the active band; ``active_elements`` overrides
    it."""
    self = _adapter_from_gfs(lset_ho, lset_p1, deform, threshold)
    band = None
    if active_elements is not None:
        band = torch.as_tensor(
            active_elements.np if hasattr(active_elements, "np")
            else active_elements, dtype=torch.bool)
    elif lower != 0.0 or upper != 0.0:
        vv = lset_vertex_values(lset_p1)
        band = (vv.min(1).values <= upper) & (vv.max(1).values >= lower)
    return self._shift_from_nodal(lset_ho, lset_p1, deform,
                                  blending=blending, band=band)


def CalcMaxDistance(lset, lset_p1, deform, heapsize=None):
    """Free-function max-distance estimate (reference
    lsetcurving/python_lsetcurving.cpp:49-60): max |lset| over the deformed
    lset_p1 zero set."""
    self = _adapter_from_gfs(
        lset if hasattr(lset, "space") else lset_p1, lset_p1, deform)
    if not hasattr(lset, "space") and deform is not None:
        self.order = deform.space.order  # quadrature order for a CF levelset
    return self.CalcMaxDistance(levelset=lset, deform=deform)


def CalcDistances(lset, lset_p1, deform, stats=None, heapsize=None,
                  refine_threshold=-1.0, absolute=False):
    """Free-function distance statistics (reference
    lsetcurving/python_lsetcurving.cpp:99-110): (max, L1, L2) of |lset|
    over the deformed lset_p1 zero set, appended to ``stats`` when given;
    with ``refine_threshold >= 0`` it also sets the mesh's refinement flags
    (``MarkForRefinement``)."""
    self = _adapter_from_gfs(
        lset if hasattr(lset, "space") else lset_p1, lset_p1, deform)
    if not hasattr(lset, "space") and deform is not None:
        self.order = deform.space.order  # quadrature order for a CF levelset
    out = self.CalcDistances(levelset=lset, stats=stats)
    if refine_threshold >= 0:
        self.MarkForRefinement(levelset=lset,
                               refine_threshold=refine_threshold,
                               absolute=absolute)
    return out
