"""H(div) space: lowest-order Raviart-Thomas (RT0) with the Piola map.

Counterpart of ``ngsxfem_tpu/fem/hdiv.py``.  The reference uses NGSolve's
HDiv spaces as a facet-normal orientation helper
(``tests/pytests/test_straightcutrule.py:338``, ``HDiv(mesh, order=0)``)
and through the HDiv variant of the ghost-penalty normal derivative
``DiffOpDuDnkHDiv`` (``xfem/ghostpenalty.hpp:27-41``,
``ghostpenalty.cpp:140-199``).  One dof per facet (outward flux of the
facet's first neighbour), the Piola-mapped value and divergence, and an
exact directional normal derivative (the shapes are polynomials: the
interpolant along the normal line is differentiated where the reference
takes central differences).
"""
from __future__ import annotations

from math import factorial

import numpy as np
import torch

from ..cf.coefficient import CF
from ..config import config
from ..mesh.mesh import FACET_VERTS, small_matmul
from .space import DeviceViews, BitArray

# RT0 reference basis scale: psi_i = C_RT0[d] * (xi - V_opp(i)), dof = flux
# through reference facet i w.r.t. the outward reference normal
_C_RT0 = {2: 1.0, 3: 2.0}


class HDiv(DeviceViews):
    """RT0 H(div) space on simplicial meshes (one dof per facet)."""

    is_compound = False

    def __init__(self, mesh, order: int = 0, dirichlet=None, device=None,
                 **kw):
        if mesh.et not in ("trig", "tet"):
            raise NotImplementedError("HDiv: simplicial meshes only")
        if order != 0:
            raise NotImplementedError(
                "HDiv order>0 (BDM/RT_k families) is not implemented; the "
                "reference usage (normal helper, DuDnkHDiv ghost penalty) "
                "is covered by RT0")
        from ..ops.cuttables import REF_VERTS

        self.mesh = mesh
        self.order = order
        self.dim = self.vdim = mesh.dim
        self.dgjumps = False
        self._device = device
        self._views = {}
        self.ndof = mesh.nfacets
        self.el2dof_np = mesh.el2facet_np.astype(np.int32)
        # orientation: +1 where this element is the facet's first neighbour
        f2e = mesh.facet2el_np
        self.eldof_sign_np = np.where(
            f2e[self.el2dof_np, 0] == np.arange(mesh.ne)[:, None], 1.0, -1.0)
        # opposite reference vertex per local facet
        refv = REF_VERTS[mesh.et]
        nvel = refv.shape[0]
        opp = [(set(range(nvel)) - set(fv)).pop()
               for fv in FACET_VERTS[mesh.et]]
        self.v_opp_np = refv[np.asarray(opp)]
        self.dirichlet_dofs = np.zeros(self.ndof, dtype=bool)
        self.bc_of_dof = np.zeros(self.ndof, dtype=np.int32)

    def FreeDofs(self, coupling=False):
        return BitArray(~self.dirichlet_dofs)

    @property
    def eldof_sign(self):
        """(ne, nfel) facet orientation signs on the space's device, in
        ``config.dtype``, as the reference holds them."""
        return self._view("eldof_sign", self.eldof_sign_np, config.dtype,
                          self.device)

    def TrialFunction(self):
        from ..forms.proxies import make_proxies

        return make_proxies(self, test=False)

    def TestFunction(self):
        from ..forms.proxies import make_proxies

        return make_proxies(self, test=True)

    def TnT(self):
        return self.TrialFunction(), self.TestFunction()

    # -- shapes ---------------------------------------------------------------
    def _tables(self, pctx):
        """(v_opp (nfel, d), sign (E, nfel)) on the context's device."""
        dev, dtype = pctx.device, pctx.dtype
        v_opp = self._view("v_opp", self.v_opp_np, dtype, dev)
        sign = self._view("eldof_sign", self.eldof_sign_np, dtype, dev)
        if pctx.elem_ids is not None:
            sign = sign[pctx.elem_ids]
        return v_opp, sign

    def _piola(self, pctx, ref_pts):
        """Piola-mapped RT0 shapes at ref_pts (E|1,Q,d) -> (E,Q,nfel,d),
        and the constant divergence (E,Q,nfel)."""
        c = _C_RT0[self.dim]
        v_opp, sign = self._tables(pctx)
        psi_ref = c * (ref_pts[:, :, None, :] - v_opp)  # (E,Q,nfel,d)
        # |det|: with a signed det, negatively oriented elements would flip
        # the outward-flux dof meaning (Kuhn tet splits contain both signs)
        detJ = pctx.detJ.abs()  # (E,Q|1)
        inv_det = 1.0 / torch.where(detJ < 1e-30, 1.0, detJ)
        # "eqid,eqgd->eqig": J[g, d] = dx_g/dxi_d
        psi = small_matmul(psi_ref, pctx.J.transpose(-1, -2)) \
            * inv_det[..., None, None]
        psi = psi * sign[:, None, :, None]
        div = ((c * self.dim) * inv_det[..., None]
               * sign[:, None, :]).expand(-1, psi.shape[1], -1)
        return psi, div

    def proxy_factor_hook(self, proxy, ctx, pctx):
        from ..forms.evaluate import Factor

        op = proxy.op
        if op == "val":
            arr = self._piola(pctx, pctx.ref_pts)[0]
        elif op == "div":
            arr = self._piola(pctx, pctx.ref_pts)[1]
        elif op == "dnk":
            arr = self._dnk(pctx, proxy.op_args[0])
        else:
            raise NotImplementedError(f"HDiv proxy op {op}")
        return Factor(block=proxy.block_key, arr=arr, space=self)

    def _dnk(self, pctx, k: int):
        """k-th directional derivative of the vector shapes along the facet
        normal (DiffOpDuDnkHDiv, ghostpenalty.cpp:140-199), exact: the RT0
        shapes are degree-1 polynomials, so a 2-point interpolant suffices.
        Returns (E,Q,nfel,d)."""
        p = self.order + 1  # polynomial degree of the shapes
        n = pctx.normal
        if n is None:
            raise TypeError("dn(..., hdiv=True) needs a facet-normal context")
        dir_ref = small_matmul(pctx.Jinv, n[..., None])[..., 0]  # (E,Q,d)
        tn = np.cos(np.pi * (2 * np.arange(p + 1) + 1) / (2 * (p + 1)))
        V = np.vander(tn, increasing=True)
        wk = (factorial(k) * np.linalg.inv(V)[k] if k <= p
              else np.zeros(p + 1))
        t = torch.as_tensor(tn, dtype=dir_ref.dtype, device=dir_ref.device)
        pts = (pctx.ref_pts[:, :, None, :]
               + t[None, None, :, None] * dir_ref[:, :, None, :])  # (E,Q,T,d)
        E, Q, T, d = pts.shape
        c = _C_RT0[self.dim]
        v_opp, sign = self._tables(pctx)
        psi_ref = c * (pts.reshape(E, Q * T, d)[:, :, None, :] - v_opp)
        # J and detJ are constant per (affine) element
        J = pctx.J[:, :1]
        detJ = pctx.detJ[:, :1].abs()
        inv_det = 1.0 / torch.where(detJ < 1e-30, 1.0, detJ)
        psi = small_matmul(psi_ref, J.transpose(-1, -2)) \
            * inv_det[..., None, None]
        psi = psi.reshape(E, Q, T, psi.shape[2], d) \
            * sign[:, None, None, :, None]
        out = 0.0
        for i, w in enumerate(wk.tolist()):  # "t,eqtid->eqid"
            out = out + w * psi[:, :, i]
        return out

    def gf_eval_hook(self, gf, ctx):
        return _HDivGFOp(gf)._eval_pure(ctx)

    def __repr__(self):
        return f"HDiv(order={self.order}, ndof={self.ndof})"


class _HDivGFOp(CF):
    """CF node: an HDiv GridFunction's (vector) value."""

    def __init__(self, gf):
        self.gf = gf
        self.dims = (gf.space.dim,)

    def _eval_pure(self, ctx):
        sp = self.gf.space
        e2d = sp.el2dof_on(ctx.device)
        if ctx.elem_ids is not None:
            e2d = e2d[ctx.elem_ids]
        psi, _ = sp._piola(ctx, ctx.ref_pts)  # (E,Q,nfel,d)
        dofs = self.gf.vec.data.to(psi.dtype)[e2d]  # (E, nfel)
        return (psi * dofs[:, None, :, None]).sum(2)  # "eqid,ei->eqd"
