"""SFESpace: 1D polynomials on the zero line of a level set (2D).

Counterpart of ``ngsxfem_tpu/fem/sfespace.py``, the port of the reference's
experimental surface space (``xfem/sFESpace.hpp:12-68``,
``sFESpace.cpp:9-145``, ``SFiniteElement`` in ``xfiniteelement.cpp:34-53``):
per cut TRIG the interface is the segment between the two edge cut points;
the element carries order+1 discontinuous dofs whose shapes are the 1D basis
at the orthogonal projection onto that segment's chord, constant in the
normal direction.  The cut points are found for all elements at once from
the P1 level-set vertex values (host numpy, as in the JAX package).
Elements the level set does not cut have placeholder slots
(``el2dof_valid_np``), which assembly leaves out.
"""
from __future__ import annotations

import numpy as np
import torch

from ..cf.coefficient import CF
from .basis import shapes
from .space import DeviceViews, BitArray


class SFESpace(DeviceViews):
    """Space of 1D polynomials on the zero line of a P1 level set (TRIGs)."""

    vdim = 1
    is_compound = False

    def __init__(self, mesh, levelset, order: int = 1, device=None, **kw):
        from ..integrate import lset_vertex_values
        from .gridfunction import GridFunction, InterpolateToP1
        from .space import H1
        from ..ops.cuttables import REF_VERTS

        if mesh.et != "trig":
            raise NotImplementedError("SFESpace: only TRIG meshes (as in the "
                                      "reference, sFESpace.cpp:86)")
        self.mesh = mesh
        self.order = int(order)
        self.dgjumps = False
        self._views = {}
        if not hasattr(levelset, "space"):
            gf = GridFunction(H1(mesh, order=1, device=device))
            InterpolateToP1(levelset, gf)
            levelset = gf
        self.levelset = levelset
        self._device = device if device is not None else levelset.device

        vals = lset_vertex_values(levelset).detach().cpu().numpy()  # (E, 3)
        refv = REF_VERTS["trig"]
        edges = [(0, 1), (0, 2), (1, 2)]  # reference order (sFESpace.cpp:111)
        E = mesh.ne
        cuts = np.zeros((E, 2, 2))
        sels, pts = [], []
        for a, b in edges:
            la, lb = vals[:, a], vals[:, b]
            sel = ((la > 0) & (lb <= 0)) | ((la <= 0) & (lb > 0))
            t = np.where(sel, -la / np.where(lb - la == 0, 1.0, lb - la), 0.0)
            pts.append((1 - t)[:, None] * refv[a][None]
                       + t[:, None] * refv[b][None])
            sels.append(sel)
        selm = np.stack(sels, axis=1)             # (E, 3)
        slot = np.cumsum(selm, axis=1) - selm     # cut edges BEFORE edge k
        for k in range(3):  # the first two cut edges in reference order
            m = sels[k] & (slot[:, k] < 2)
            cuts[np.nonzero(m)[0], slot[m, k]] = pts[k][m]
        self.active = selm.sum(axis=1) >= 2
        nact = int(self.active.sum())
        ndl = self.order + 1
        self.ndof = nact * ndl
        # element -> dofs, placeholder 0 on inactive elements
        first = np.zeros(E, dtype=np.int64)
        first[self.active] = np.arange(nact) * ndl
        self.el2dof_np = np.where(
            self.active[:, None], first[:, None] + np.arange(ndl)[None], 0
        ).astype(np.int32)
        self.el2dof_valid_np = np.broadcast_to(self.active[:, None],
                                               (E, ndl)).copy()
        self.cuts_np = cuts
        self.dirichlet_dofs = np.zeros(self.ndof, dtype=bool)
        self.bc_of_dof = np.zeros(self.ndof, dtype=np.int32)

    def FreeDofs(self, coupling=False):
        return BitArray(~self.dirichlet_dofs)

    def TrialFunction(self):
        from ..forms.proxies import make_proxies

        return make_proxies(self, test=False)

    def TestFunction(self):
        from ..forms.proxies import make_proxies

        return make_proxies(self, test=True)

    def TnT(self):
        return self.TrialFunction(), self.TestFunction()

    def CutElements(self) -> BitArray:
        return BitArray(self.active)

    # -- evaluation -------------------------------------------------------------
    def _basis(self, ctx):
        """(E, Q, ndl) 1D shapes at the chord projection of the context's
        points, zero on inactive elements."""
        cuts = self._view("cuts", self.cuts_np, ctx.dtype, ctx.device)
        act = self.el2dof_valid_on(ctx.device)
        if ctx.elem_ids is not None:
            cuts, act = cuts[ctx.elem_ids], act[ctx.elem_ids]
        c0 = cuts[:, None, 0, :]  # (E,1,2)
        dref = cuts[:, None, 1, :] - c0
        den = (dref * dref).sum(-1)
        den = torch.where(den < 1e-30, 1.0, den)
        xhat = ((ctx.ref_pts - c0) * dref).sum(-1) / den  # (E,Q)
        B = shapes("segm", self.order, xhat[..., None])  # (E,Q,ndl)
        return torch.where(act[:, None, :], B, 0.0)

    def proxy_factor_hook(self, proxy, ctx, pctx):
        from ..forms.evaluate import Factor

        if proxy.op != "val":
            raise NotImplementedError(
                "SFESpace supports value evaluation only (the reference "
                "SFiniteElement::CalcDShape also throws)")
        return Factor(block=proxy.block_key, arr=self._basis(pctx),
                      space=self)

    def gf_eval_hook(self, gf, ctx):
        return _SGFOp(gf)._eval_pure(ctx)

    def __repr__(self):
        return f"SFESpace(order={self.order}, ndof={self.ndof})"


class _SGFOp(CF):
    """CF node: a GridFunction on an SFESpace."""

    def __init__(self, gf):
        self.gf = gf
        self.dims = ()

    def _eval_pure(self, ctx):
        sp = self.gf.space
        e2d = sp.el2dof_on(ctx.device)
        if ctx.elem_ids is not None:
            e2d = e2d[ctx.elem_ids]
        B = sp._basis(ctx)  # zero on inactive elements
        dofs = self.gf.vec.data.to(B.dtype)[e2d]
        return (B * dofs[:, None, :]).sum(-1)  # "eqi,ei->eq"
