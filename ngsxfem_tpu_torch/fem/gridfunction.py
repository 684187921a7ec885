"""GridFunctions: dof vectors with CF evaluation hooks.

Counterpart of ``ngsxfem_tpu/fem/gridfunction.py`` for scalar ``H1`` spaces.
A GridFunction IS a CoefficientFunction (as in NGSolve); its evaluation at
a batch of quadrature points is a gather + contraction over the basis tables
from ``fem.basis``.  The dof vector is a tensor on the GridFunction's device
in ``config.dtype``; ``gf.vec.data = array`` replaces it (from numpy or a
tensor), ``gf.vec.NumPy()`` reads it back.
"""
from __future__ import annotations

import torch

from ..config import config, resolve_device
from ..cf.coefficient import CF, wrap
from ..cf.context import EvalCtx, eval_pure
from ..mesh.mesh import small_matmul
from .basis import shapes, dshapes
from .space import H1


class VecShim:
    """NGSolve-ish view of a GridFunction's dof vector: ``gf.vec.data = v``
    replaces it, ``gf.vec.NumPy()`` copies it to the host."""

    def __init__(self, gf):
        self._gf = gf

    @property
    def data(self):
        return self._gf._array

    @data.setter
    def data(self, v):
        self._gf._set_array(v)

    def NumPy(self):
        return self._gf._array.detach().cpu().numpy()


class GridFunction(CF):
    """Scalar GridFunction on an ``H1`` space.  Its vector lives on
    ``device`` (default: the space's device, the card unless the caller
    asks for the CPU; without a card and without that argument it raises)
    in ``dtype`` (default ``config.dtype``)."""

    def __init__(self, space, name="gf", device=None, dtype=None):
        if not isinstance(space, H1):
            raise NotImplementedError(
                "GridFunction on spaces other than H1 (ROADMAP A9)")
        self.space = space
        self.name = name
        self.device = resolve_device(device if device is not None
                                     else space._device)
        self.dtype = config.dtype if dtype is None else dtype
        self._array = torch.zeros(space.ndof, dtype=self.dtype,
                                  device=self.device)
        self.dims = ()

    # -- dof vector ---------------------------------------------------------
    def _set_array(self, v):
        v = torch.as_tensor(v, dtype=self.dtype, device=self.device)
        if v.shape != (self.space.ndof,):
            raise ValueError(f"vector of shape {tuple(v.shape)} for "
                             f"{self.space.ndof} dofs")
        self._array = v

    @property
    def vec(self):
        return VecShim(self)

    # -- interpolation ------------------------------------------------------
    def Set(self, cf, boundary=False, definedonelements=None, BND=None):
        """Nodal interpolation of `cf` (NGSolve ``GridFunction.Set``
        analog): `cf` evaluated at each dof's Lagrange node."""
        if boundary or BND or definedonelements is not None:
            raise NotImplementedError(
                "Set with boundary/definedonelements (ROADMAP A9)")
        sp = self.space
        ref = torch.as_tensor(sp.dof_rep_ref, dtype=self.dtype,
                              device=self.device)[:, None, :]
        ids = torch.as_tensor(sp.dof_rep_elem, dtype=torch.int64,
                              device=self.device)
        ctx = EvalCtx(sp.mesh, ref, elem_ids=ids)
        vals = torch.broadcast_to(eval_pure(wrap(cf), ctx), (sp.ndof, 1))
        self._set_array(vals[:, 0])

    def Deriv(self):
        return GradGF(self)

    # -- CF evaluation ------------------------------------------------------
    def _eval_pure(self, ctx: EvalCtx):
        return gf_value(self, ctx.elem_ids, ctx.ref_pts)

    def __repr__(self):
        return f"GridFunction({self.space}, name={self.name})"


class GradGF(CF):
    def __init__(self, gf: GridFunction):
        self.gf = gf
        self.dims = (gf.space.mesh.dim,)

    def _eval_pure(self, ctx: EvalCtx):
        _, gref = gf_ref_value_and_grad(self.gf, ctx.elem_ids, ctx.ref_pts)
        # push-forward: g_phys[g] = sum_d gref[d] Jinv[d, g]
        return small_matmul(gref[..., 0, None, :], ctx.Jinv)[..., 0, :]


def _elem_dofs(gf: GridFunction, elem_ids):
    e2d = gf.space.el2dof_on(gf.device)
    if elem_ids is not None:
        e2d = e2d[elem_ids]
    return gf._array[e2d]  # (E, ndl)


def gf_value(gf: GridFunction, elem_ids, ref_pts):
    """Value of gf at (elem, refpt) batches -> (E,Q)."""
    sp = gf.space
    B = shapes(sp.mesh.et, sp.order, ref_pts)  # (E|1,Q,ndl)
    dofs = _elem_dofs(gf, elem_ids)
    return (B * dofs[:, None, :]).sum(-1)


def gf_ref_value_and_grad(gf: GridFunction, elem_ids, ref_pts):
    """(value (E,Q,1), ref-grad (E,Q,1,d)) of gf at ref points."""
    sp = gf.space
    B = shapes(sp.mesh.et, sp.order, ref_pts)  # (E|1,Q,ndl)
    G = dshapes(sp.mesh.et, sp.order, ref_pts)  # (E|1,Q,ndl,d)
    dofs = _elem_dofs(gf, elem_ids)
    val = (B * dofs[:, None, :]).sum(-1, keepdim=True)  # (E,Q,1)
    grad = (G * dofs[:, None, :, None]).sum(-2)  # (E,Q,d)
    return val, grad[..., None, :]


def grad(obj):
    """grad() for GridFunctions (NGSolve-style free function)."""
    if isinstance(obj, GridFunction):
        return GradGF(obj)
    raise TypeError(f"grad() not supported for {type(obj)}")


def InterpolateToP1(levelset, gf_p1: GridFunction, eps_perturbation=None):
    """Vertex interpolation of a level set into a P1 GridFunction
    (cf. utils/p1interpol.hpp:25-37).  The epsilon-guard against exact zeros
    is applied later inside the cut kernels (ops/straightcut.py:eps_guard)."""
    sp = gf_p1.space
    if not isinstance(sp, H1) or sp.order != 1:
        raise TypeError("InterpolateToP1 target must be an order-1 H1 GridFunction")
    gf_p1.Set(wrap(levelset))
