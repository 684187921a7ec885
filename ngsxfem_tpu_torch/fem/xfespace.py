"""XFESpace — Heaviside-enrichment space for XFEM.

Counterpart of ``ngsxfem_tpu/fem/xfespace.py`` (the reference's enrichment
space, ``xfem/xFESpace.hpp:22-206``, dof maps ``xFESpace.cpp:302-321``, sign
assignment ``:345-366``, masked diff-ops ``xfem/xfemdiffops.cpp:7-67``): an
x-dof doubles a base dof on cut elements; its enrichment function is
psi_i = phi_i * chi_{dom(i)} with dom(i) the domain NOT containing the dof's
node.  A node's support elements never lie in the opposite uncut domain, so
psi_i is supported on cut elements only: the dof set is "the base dofs of
IF elements" and evaluation is a sign mask on the base basis.

Operators (python/__init__.py:22-105 of the reference):
  extend(u)      base shapes, unmasked
  neg(u)/pos(u)  base shapes masked to dofs enriching NEG/POS
  *_grad         the corresponding gradients

The dof bookkeeping is host numpy; the element masks go to the device of
the evaluation.  The ``trace=True`` LOCAL_DOF marks are kept for the static
condensation (``solvers/condense.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..cf.coefficient import CF
from ..domaintype import DOMAIN_TYPE, IF, NEG, POS
from ..mesh.mesh import small_matmul
from .basis import dshapes, facet_local_nodes, shapes
from .space import BitArray, DeviceViews, FESpace


class XFESpace(DeviceViews):
    """Enrichment space over a scalar base FESpace, on the base space's
    device."""

    vdim = 1
    is_compound = False

    def __init__(self, basefes: FESpace, lset_or_cutinfo=None, cutinfo=None,
                 trace=False, **kw):
        from ..geom.cutinfo import BND, CutInfo
        from .gridfunction import GridFunction

        self.base = basefes
        self.mesh = basefes.mesh
        self.order = basefes.order
        self.trace = trace
        self._device = basefes._device
        self._views = {}
        if isinstance(lset_or_cutinfo, CutInfo):
            self.cutinfo = lset_or_cutinfo
        else:
            self.cutinfo = CutInfo(self.mesh, lset_or_cutinfo,
                                   device=basefes._device)
        if cutinfo is not None:
            self.cutinfo = cutinfo

        # level-set value at every base dof node -> dof side
        lset = getattr(self.cutinfo, "_lset_gf", None)
        if lset is None:
            raise ValueError("XFESpace needs the level set (GridFunction)")
        tmp = GridFunction(basefes)
        tmp.Set(lset)
        phi_at_dofs = tmp.vec.NumPy()
        # dom of xdof = INVERT(side of node): node in NEG -> enriches POS
        self.dom_of_basedof = np.where(phi_at_dofs < 0, int(POS),
                                       int(NEG)).astype(np.int8)

        cutels = self.cutinfo.GetElementsOfType(IF).np
        active = np.zeros(basefes.ndof, dtype=bool)
        active[basefes.el2dof_np[cutels].ravel()] = True
        self.basedof2xdof = np.full(basefes.ndof, -1, dtype=np.int32)
        self.xdof2basedof = np.nonzero(active)[0].astype(np.int32)
        self.basedof2xdof[self.xdof2basedof] = np.arange(
            len(self.xdof2basedof), dtype=np.int32)
        self.ndof = int(active.sum())
        mapped = self.basedof2xdof[basefes.el2dof_np]
        self.el2dof_np = np.where(mapped >= 0, mapped, 0).astype(np.int32)
        # placeholder-0 slots are NOT dof 0; set algebra must skip them
        self.el2dof_valid_np = mapped >= 0
        # per element-local dof: the domain its enrichment lives on
        self.eldof_dom_np = self.dom_of_basedof[basefes.el2dof_np].astype(
            np.int32)
        self.dom_of_xdof = self.dom_of_basedof[self.xdof2basedof]
        # Dirichlet where the cut touches the boundary (xFESpace.cpp:368-399):
        # an enrichment dof is Dirichlet iff its base dof is Dirichlet AND it
        # has support on a boundary element crossed by the interface
        self.dirichlet_dofs = np.zeros(self.ndof, dtype=bool)
        mesh = basefes.mesh
        if len(mesh.boundary_facets_np):
            bnd_if = self.cutinfo.GetElementsOfType(IF, VOL_or_BND=BND).np
            if bnd_if.any() and basefes.dirichlet_dofs.any():
                lfn = facet_local_nodes(mesh.et, self.order)
                cut_on_bnd = np.zeros(self.ndof, dtype=bool)
                bfs = mesh.boundary_facets_np[bnd_if]
                e = mesh.facet2el_np[bfs, 0]
                lf = mesh.facet2elloc_np[bfs, 0]
                for loc, ids in enumerate(lfn):
                    sel = lf == loc
                    if sel.any() and len(ids):
                        xd = self.basedof2xdof[
                            basefes.el2dof_np[e[sel]][:, ids].ravel()]
                        cut_on_bnd[xd[xd >= 0]] = True
                self.dirichlet_dofs = (
                    cut_on_bnd & basefes.dirichlet_dofs[self.xdof2basedof])
        self.bc_of_dof = np.zeros(self.ndof, dtype=np.int32)
        self.dgjumps = basefes.dgjumps

        # trace-dof condensation marks (reference xFESpace.cpp:72-97): with
        # trace=True in 3D, face-interior dofs of faces adjacent to < 2 cut
        # elements (the outer rim of the band) become LOCAL_DOF
        self.local_dofs = np.zeros(self.ndof, dtype=bool)
        if trace and self.mesh.dim == 3 and self.order >= 1:
            fnodes = facet_local_nodes(self.mesh.et, self.order,
                                       interior_only=True)
            f2e = self.mesh.facet2el_np
            cut = np.asarray(cutels)
            nb = cut[f2e[:, 0]].astype(np.int32) + np.where(
                f2e[:, 1] >= 0, cut[np.maximum(f2e[:, 1], 0)], 0)
            weak = nb < 2  # faces on the outer rim of the cut band
            for lf, nodeids in enumerate(fnodes):
                if len(nodeids) == 0:
                    continue
                sel = np.nonzero(weak[self.mesh.el2facet_np[:, lf]])[0]
                if len(sel) == 0:
                    continue
                bds = basefes.el2dof_np[np.ix_(sel, np.asarray(nodeids))]
                xd = self.basedof2xdof[bds.ravel()]
                self.local_dofs[xd[xd >= 0]] = True

    def LocalDofs(self) -> BitArray:
        """Dofs marked LOCAL_DOF for static condensation (trace=True)."""
        return BitArray(self.local_dofs)

    def GetCutInfo(self):
        return self.cutinfo

    def BaseDofOfXDof(self, i):
        """Base-space dof of extended dof ``i`` (xFESpace.hpp
        GetBaseDofOfXDof)."""
        return int(self.xdof2basedof[i])

    def GetDomainOfDof(self, i):
        """Domain (NEG/POS) the enrichment of extended dof ``i`` has support
        on (xFESpace.cpp GetDomainOfDof)."""
        return DOMAIN_TYPE(int(self.dom_of_xdof[i]))

    def GetDomainNrs(self, elnr):
        """Domains of the extended dofs on (cut) element ``elnr`` in
        element-local dof order; empty when the element is not cut
        (xFESpace.cpp:30-42)."""
        if not bool(self.cutinfo.GetElementsOfType(IF).np[elnr]):
            return []
        xdofs = self.el2dof_np[elnr][self.el2dof_valid_np[elnr]]
        return [DOMAIN_TYPE(int(d)) for d in self.dom_of_xdof[xdofs]]

    def FreeDofs(self, coupling=False):
        """Free dofs; with coupling=True, LOCAL (condensable) dofs are
        excluded (NGSolve's FreeDofs(True) convention)."""
        free = ~self.dirichlet_dofs
        if coupling:
            free = free & ~self.local_dofs
        return BitArray(free)

    def TrialFunction(self):
        from ..forms.proxies import make_proxies

        return make_proxies(self, test=False)

    def TestFunction(self):
        from ..forms.proxies import make_proxies

        return make_proxies(self, test=True)

    def TnT(self):
        return self.TrialFunction(), self.TestFunction()

    def Update(self):
        pass

    def elem_mask(self, elem_ids, side, device):
        """(E, ndl) bool: the element-local dofs that are active and, for
        ``side`` NEG/POS, enrich that side (all active ones for None)."""
        act = self._view("eldof_active", self.el2dof_valid_np, torch.bool,
                         device)
        dom = self._view("eldof_dom", self.eldof_dom_np, torch.int32, device)
        if elem_ids is not None:
            act, dom = act[elem_ids], dom[elem_ids]
        return act if side is None else act & (dom == side)

    def gf_eval_hook(self, gf, ctx):
        """Default GridFunction evaluation: ``extend``."""
        return _XGFOp(gf, None)._eval_pure(ctx)

    def proxy_factor_hook(self, proxy, ctx, pctx):
        """The basis factor of a proxy: base shapes or gradients, masked
        to the dofs of the operator's side."""
        from ..forms.evaluate import Factor

        et, order = self.mesh.et, self.order
        op = proxy.op
        if op in ("val", "xext", "xneg", "xpos"):
            arr = shapes(et, order, pctx.ref_pts)
        elif op in ("grad", "xextgrad", "xneggrad", "xposgrad"):
            arr = small_matmul(dshapes(et, order, pctx.ref_pts), pctx.Jinv)
        else:
            raise NotImplementedError(f"XFESpace proxy op {op}")
        side = _OP_SIDE.get(op)
        m = self.elem_mask(pctx.elem_ids, side, pctx.device)[:, None, :]
        if arr.ndim == 4:
            m = m[..., None]
        return Factor(block=proxy.block_key, arr=torch.where(m, arr, 0.0),
                      space=self)

    def __repr__(self):
        return f"XFESpace(ndof={self.ndof}, base={self.base})"


_OP_SIDE = {"xneg": int(NEG), "xpos": int(POS), "xneggrad": int(NEG),
            "xposgrad": int(POS)}


class _XGFOp(CF):
    """CF node: masked evaluation of a GridFunction on an XFESpace."""

    def __init__(self, gf, side, grad=False):
        self.gf = gf
        self.side = side  # None = extend
        self.grad = grad
        self.dims = (gf.space.mesh.dim,) if grad else ()

    def _eval_pure(self, ctx):
        sp = self.gf.space
        et, order = sp.mesh.et, sp.order
        e2d = sp.el2dof_on(ctx.device)
        if ctx.elem_ids is not None:
            e2d = e2d[ctx.elem_ids]
        mask = sp.elem_mask(ctx.elem_ids, self.side, ctx.device)
        dofs = torch.where(mask, self.gf.vec.data.to(ctx.device)[e2d], 0.0)
        if not self.grad:
            B = shapes(et, order, ctx.ref_pts)
            return (B * dofs[:, None, :]).sum(-1)  # "eqi,ei->eq"
        G = dshapes(et, order, ctx.ref_pts)
        gref = (G * dofs[:, None, :, None]).sum(-2)  # "eqid,ei->eqd"
        return small_matmul(gref[..., None, :], ctx.Jinv)[..., 0, :]


def _xop(obj, op_name, side, grad):
    from ..forms.proxies import ProxyFunction
    from .gridfunction import GridFunction

    if isinstance(obj, ProxyFunction):
        if not isinstance(obj.space, XFESpace):
            raise TypeError(f"{op_name} needs an XFESpace function")
        d = obj.space.mesh.dim
        return obj._clone(op=op_name, dims=(d,) if grad else ())
    if isinstance(obj, GridFunction) and isinstance(obj.space, XFESpace):
        return _XGFOp(obj, side, grad)
    raise TypeError(f"{op_name} expects an XFESpace proxy or GridFunction")


def neg(u):
    return _xop(u, "xneg", int(NEG), False)


def pos(u):
    return _xop(u, "xpos", int(POS), False)


def extend(u):
    return _xop(u, "xext", None, False)


def neg_grad(u):
    return _xop(u, "xneggrad", int(NEG), True)


def pos_grad(u):
    return _xop(u, "xposgrad", int(POS), True)


def extend_grad(u):
    return _xop(u, "xextgrad", None, True)


def XToNegPos(gfx, gfnegpos):
    """Copy an XFESpace GridFunction into a two-field compound
    representation (cf. xfem/xFESpace.cpp:105-144)."""
    sp = gfx.space
    neg_part = np.zeros(sp.base.ndof)
    pos_part = np.zeros(sp.base.ndof)
    vec = gfx.vec.NumPy()
    bd = sp.xdof2basedof
    is_neg = sp.dom_of_xdof == int(NEG)
    neg_part[bd[is_neg]] = vec[is_neg]
    pos_part[bd[~is_neg]] = vec[~is_neg]
    gfnegpos.components[0].vec = neg_part
    gfnegpos.components[1].vec = pos_part
