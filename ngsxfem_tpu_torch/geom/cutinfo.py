"""Cut topology bookkeeping — CutInfo and the facet/element/dof set algebra.

Counterpart of ``ngsxfem_tpu/geom/cutinfo.py`` (reference: CutInformation,
Update at ``xfem/cutinfo.cpp:54-188``; facet/dof algebra ``:191-329``):
element and vertex classification and the cut ratios (from the order-0 cut
rule on the cut elements) are batched tensor reductions on the device of
the level set; the results, and all mark sets, are host numpy arrays
(``BitArray``), as in the reference.  A space-time level set (``Update``
of a GridFunction on a ``SpaceTimeFESpace``) classifies an element as cut
if it is cut at any time node or interior Gauss time of the slab, and takes
its cut ratio from the order-0 space-time rule.
"""
from __future__ import annotations

import numpy as np
import torch

from ..domaintype import NEG, POS, IF, as_cdt
from ..fem.space import BitArray, _arr
from ..fem.facetspace import GetDofsOfFacets  # noqa: F401 (the API's place)
from ..cf.coefficient import ElementValuesCF, FacetValuesCF
from ..ops.straightcut import cut_rule_element, eps_guard
from ..integrate import (ensure_p1_levelset, lset_st_vertex_values,
                         lset_vertex_values, _p1_vertex_dofs)
from ..utils.timing import Timer, traced

VOL = "VOL"
BND = "BND"


def _classify(et, vals):
    """Eps-guard, sign classification and order-0 cut ratios of (E, nvel)
    vertex values: (has_neg, has_pos, NEG ratio, guarded values).  The cut
    rule runs on the cut elements only: on an uncut one it gives the ratio
    exactly 1 (NEG) or 0 (POS)."""
    vg = eps_guard(vals)
    has_neg = (vg < 0).any(1)
    has_pos = (vg > 0).any(1)
    ratio = has_neg.to(vals.dtype)
    cut = torch.nonzero(has_neg & has_pos)[:, 0]
    rule = cut_rule_element(et, vals[cut], 0)
    ratio[cut] = (rule.w * (rule.side == 0)).sum(1) / rule.w.sum(1)
    return has_neg, has_pos, ratio, vg


def _dt(has_neg, has_pos):
    """Host int8 domain type per row from the device sign masks."""
    has_neg, has_pos = has_neg.cpu().numpy(), has_pos.cpu().numpy()
    return np.where(has_neg & has_pos, int(IF),
                    np.where(has_neg, int(NEG), int(POS))).astype(np.int8)


class CutInfo:
    """Per-mesh cut bookkeeping (cf. xfem/cutinfo.hpp:21-92).  A level set
    that is not a P1 GridFunction is interpolated to P1 on ``device`` (the
    card unless the caller asks for the CPU)."""

    def __init__(self, mesh, levelset=None, time_order=-1, device=None):
        self.mesh = mesh
        self.device = device
        self.dt_of_elem = None
        self.cut_ratio = None
        if levelset is not None:
            self.Update(levelset, time_order=time_order)

    @traced("CutInfo::Update")
    def Update(self, levelset, time_order=-1, heapsize=None):
        from ..spacetime.space import SpaceTimeFESpace

        mesh = self.mesh
        if isinstance(getattr(levelset, "space", None), SpaceTimeFESpace):
            self._lset_gf = levelset
            return self._update_spacetime(levelset, time_order)
        levelset = ensure_p1_levelset(levelset, mesh, self.device,
                                      cache_on=self)
        self._lset_gf = levelset
        with Timer("CutInfo::Update::classify", block=False):
            has_neg, has_pos, ratio, vg = _classify(
                mesh.et, lset_vertex_values(levelset))
            # vertex domain classification (dom_of_node analog,
            # cutinfo.cpp:151-186)
            els = mesh.device_view(vg.device, vg.dtype)[1].reshape(-1)
            vneg = torch.zeros(mesh.nv, dtype=torch.int32, device=vg.device)
            vpos = torch.zeros(mesh.nv, dtype=torch.int32, device=vg.device)
            vneg.index_add_(0, els, (vg < 0).to(torch.int32).reshape(-1))
            vpos.index_add_(0, els, (vg > 0).to(torch.int32).reshape(-1))
        with Timer("CutInfo::Update::marks", block=False):
            self.dt_of_elem = _dt(has_neg, has_pos)
            self.cut_ratio = ratio.cpu().numpy()
            self.dt_of_vertex = _dt(vneg > 0, vpos > 0)

            # facet classification from its elements (used by facet set
            # queries)
            f2e = mesh.facet2el_np
            dtl = self.dt_of_elem[f2e[:, 0]]
            dtr = np.where(f2e[:, 1] >= 0,
                           self.dt_of_elem[np.maximum(f2e[:, 1], 0)], dtl)
            bits_l = np.left_shift(1, dtl.astype(np.int32))
            bits_r = np.left_shift(1, dtr.astype(np.int32))
            self.cdt_of_facet = (bits_l | bits_r).astype(np.int8)

            # boundary ("BND") element classification + ratios: the
            # reference Update loops VOL and BND (xfem/cutinfo.cpp:54-188);
            # BND elements are the boundary facets, classified by the
            # codim-1 cut rule
            self._update_bnd(levelset)

    def _update_bnd(self, levelset):
        from ..mesh.mesh import FACET_ET

        mesh = self.mesh
        bf = mesh.boundary_facets_np
        if len(bf) == 0:
            self.dt_of_belem = np.zeros(0, dtype=np.int8)
            self.cut_ratio_bnd = np.zeros(0)
            return
        vdofs = _p1_vertex_dofs(levelset.space)
        idx = torch.as_tensor(vdofs[mesh.facets_np[bf]], dtype=torch.int64,
                              device=levelset.device)
        has_neg, has_pos, ratio, _ = _classify(FACET_ET[mesh.et],
                                               levelset.vec.data[idx])
        self.dt_of_belem = _dt(has_neg, has_pos)
        self.cut_ratio_bnd = ratio.cpu().numpy()

    def _update_spacetime(self, levelset, time_order):
        """Space-time classification: an element is IF if it is cut at any
        time node or interior Gauss time of the slab; its NEG ratio comes
        from the order-0 space-time rule, built on the elements whose rule
        is not the plain one (``spacetime_split``; the others have ratio
        1 or 0, as that rule gives them)."""
        from ..ops.gauss import gauss_legendre_01
        from ..ops.spacetimecut import spacetime_cut_rule, spacetime_split

        mesh = self.mesh
        sp = levelset.space
        with Timer("CutInfo::Update::classify", block=False):
            vals_st = lset_st_vertex_values(levelset)  # (E, ndt, nvel)
            ts = np.concatenate([sp.tfe.nodes,
                                 gauss_legendre_01(max(2, sp.k_t + 1))[0]])
            Bt = torch.as_tensor(sp.tfe.eval_np(ts), dtype=vals_st.dtype,
                                 device=vals_st.device)  # (nt, ndt)
            # "tm,emv->etv", then the sign-collapsing zero guard of the
            # rule's eps_guard (|v| < 1e-14 -> +1e-14, the reference's
            # spacetimecutrule.cpp:132), so that this classification and
            # the rule agree
            g = eps_guard((Bt[None, :, :, None] * vals_st[:, None]).sum(2))
            has_neg = (g < 0).any(2).any(1)
            has_pos = (g > 0).any(2).any(1)
            to = time_order if time_order >= 0 else sp.k_t
            split = spacetime_split(vals_st, sp.k_t, to)
            ratio = (split == 0).to(vals_st.dtype)
            cut = torch.nonzero(split < 0)[:, 0]
            rule = spacetime_cut_rule(mesh.et, vals_st[cut], sp.k_t, 0, to)
            ratio[cut] = (rule.w * (rule.side == 0)).sum(1) / rule.w.sum(1)
        with Timer("CutInfo::Update::marks", block=False):
            self.dt_of_elem = _dt(has_neg, has_pos)
            self.cut_ratio = ratio.cpu().numpy()
            f2e = mesh.facet2el_np
            dtl = self.dt_of_elem[f2e[:, 0]]
            dtr = np.where(f2e[:, 1] >= 0,
                           self.dt_of_elem[np.maximum(f2e[:, 1], 0)], dtl)
            self.cdt_of_facet = (
                np.left_shift(1, dtl.astype(np.int32))
                | np.left_shift(1, dtr.astype(np.int32))).astype(np.int8)
        self.dt_of_vertex = None
        self.dt_of_belem = None
        self.cut_ratio_bnd = None

    # -- queries -------------------------------------------------------------
    @traced("GetElementsOfType")
    def GetElementsOfType(self, dt=IF, VOL_or_BND=VOL) -> BitArray:
        cdt = int(as_cdt(dt))
        if VOL_or_BND != VOL and self.dt_of_belem is None:
            raise NotImplementedError(
                "BND element queries for space-time level sets")
        dts = self.dt_of_elem if VOL_or_BND == VOL else self.dt_of_belem
        bits = np.left_shift(1, dts.astype(np.int32))
        return BitArray((bits & cdt) == bits)

    def GetFacetsOfType(self, dt=IF) -> BitArray:
        cdt = int(as_cdt(dt))
        # facet marked if its combined type is contained in the query mask
        return BitArray((self.cdt_of_facet & ~cdt) == 0)

    def GetCutRatios(self, VOL_or_BND=VOL):
        if VOL_or_BND == VOL:
            return self.cut_ratio
        if self.cut_ratio_bnd is None:
            raise NotImplementedError(
                "BND cut ratios for space-time level sets")
        return self.cut_ratio_bnd

    def GetElementsWithThresholdContribution(self, dt=NEG, threshold=1.0):
        r = self.cut_ratio if int(dt) == int(NEG) else 1.0 - self.cut_ratio
        return BitArray(r >= threshold)


# -- facet / element set algebra (cf. xfem/cutinfo.cpp:191-329) -------------


@traced("GetFacetsWithNeighborTypes")
def GetFacetsWithNeighborTypes(mesh, a, b=None, bnd_val_a=True, bnd_val_b=True,
                               use_and=True, ngsxfemcompat=True) -> BitArray:
    """Facets whose neighbor elements satisfy (a_left & b_right)|(b_left & a_right)
    (or the OR-version with use_and=False)."""
    a = _arr(a)
    b = a if b is None else _arr(b)
    f2e = mesh.facet2el_np
    e1 = f2e[:, 0]
    e2 = f2e[:, 1]
    interior = e2 >= 0
    a1 = a[e1]
    b1 = b[e1]
    a2 = np.where(interior, a[np.maximum(e2, 0)], bnd_val_a)
    b2 = np.where(interior, b[np.maximum(e2, 0)], bnd_val_b)
    # a periodic boundary facet takes its partner's element as the right
    # neighbour; only the lower-numbered facet of the pair is marked
    # (reference xfem/cutinfo.cpp:224-235, the GetPeriodicFacet branch)
    pf = mesh.periodic_facet_np
    has_per = (~interior) & (pf >= 0)
    if has_per.any():
        pe = f2e[np.maximum(pf, 0), 0]
        a2 = np.where(has_per, a[pe], a2)
        b2 = np.where(has_per, b[pe], b2)
    if use_and:
        out = (a1 & b2) | (b1 & a2)
    else:
        out = (a1 | b2) & (b1 | a2)
    return BitArray(out & ~(has_per & (pf < np.arange(len(pf)))))


def GetElementsWithNeighborFacets(mesh, facets) -> BitArray:
    f = _arr(facets)
    out = np.zeros(mesh.ne, dtype=bool)
    f2e = mesh.facet2el_np
    sel = np.nonzero(f)[0]
    for s in range(2):
        es = f2e[sel, s]
        out[es[es >= 0]] = True
    # a marked periodic facet: its partner's element is a neighbour too
    partners = mesh.periodic_facet_np[sel]
    out[f2e[partners[partners >= 0], 0]] = True
    return BitArray(out)


def IndicatorCF(mesh, ba, facets=False):
    """1 on marked elements/facets else 0 (python/__init__.py:380)."""
    vals = _arr(ba).astype(np.float64)
    if facets:
        return FacetValuesCF(vals, mesh)
    return ElementValuesCF(vals, mesh)


def CutRatioGF(cutinfo: CutInfo):
    """Element-wise cut ratio CF (python/__init__.py:397)."""
    return ElementValuesCF(cutinfo.cut_ratio, cutinfo.mesh)


def BitArrayCF(ba, mesh=None):
    """CF = 1 on marked elements else 0 (utils/bitarraycf.hpp:10-21)."""
    return ElementValuesCF(_arr(ba).astype(np.float64), mesh)
