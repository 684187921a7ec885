"""GridFunctions: dof vectors with CF evaluation hooks.

Counterpart of ``ngsxfem_tpu/fem/gridfunction.py:32-407`` for ``H1``,
``L2``, ``NumberSpace`` and vector spaces, their ``Compress``ed
restrictions, ``XFESpace``, ``SpaceTimeFESpace`` (``Set`` node by node in
time, evaluation at the context's time), ``FacetFESpace``, ``HDiv`` and
``SFESpace`` (evaluated by their spaces' ``gf_eval_hook``) and compounds of
them (without the jit cache of ``Set``).  A GridFunction
IS a CoefficientFunction (as in NGSolve); its evaluation at a batch of
quadrature points is a gather + contraction over the basis tables from
``fem.basis``, of every component for a vector space.  The dof vector is a
tensor on the GridFunction's device in ``config.dtype``; ``gf.vec.data =
array`` replaces it (from numpy or a tensor), ``gf.vec.NumPy()`` reads it
back.  A component of a compound GridFunction (``gf.components``) reads and
writes its block of the parent's vector in place.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import as_input, config, resolve_device
from ..cf.coefficient import CF, wrap
from ..cf.context import EvalCtx, eval_pure
from ..mesh.mesh import small_matmul
from ..utils.timing import traced
from .basis import shapes, dshapes
from .space import (CompoundFESpace, FESpace, H1, GetDofsOfElements,
                    VectorFESpace)


class VecShim:
    """NGSolve-ish view of a GridFunction's dof vector.

    Supports ``gfu.vec.data = expr``, ``gfu.vec[:] = 0.0``,
    ``gfu.vec.CreateVector()``, ``gfu.vec.FV().NumPy()``.
    """

    def __init__(self, gf):
        self._gf = gf

    @property
    def data(self):
        return self._gf._arr

    @data.setter
    def data(self, v):
        self._gf._set_array(_a(v))

    def __setitem__(self, idx, v):
        arr = self._gf._arr.clone()
        arr[idx] = torch.as_tensor(_a(v), dtype=arr.dtype, device=arr.device)
        self._gf._set_array(arr)

    def __getitem__(self, idx):
        return self._gf._arr[idx]

    def __len__(self):
        return self._gf._arr.shape[0]

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.NumPy(), dtype=dtype)

    def CreateVector(self):
        return StandaloneVec(torch.zeros_like(self._gf._arr))

    def FV(self):
        return self

    def NumPy(self):
        return self._gf._arr.detach().cpu().numpy()

    # arithmetic delegates to the underlying tensor
    def __add__(self, o):
        return self._gf._arr + _a(o)

    def __sub__(self, o):
        return self._gf._arr - _a(o)

    def __mul__(self, o):
        return self._gf._arr * o

    def __rmul__(self, o):
        return o * self._gf._arr


class _CompVecShim(VecShim):
    """vec shim of a component GridFunction: reads the parent's block and
    writes through to it; a named class for isinstance checks."""


class StandaloneVec:
    """A dof vector without a GridFunction (``LinearForm.vec``,
    ``vec.CreateVector()``)."""

    def __init__(self, arr):
        self.arr = arr

    @property
    def data(self):
        return self.arr

    @data.setter
    def data(self, v):
        self.arr = torch.as_tensor(_a(v), dtype=self.arr.dtype,
                                   device=self.arr.device)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.arr.detach().cpu().numpy(), dtype=dtype)

    def __setitem__(self, idx, v):
        arr = self.arr.clone()
        arr[idx] = torch.as_tensor(_a(v), dtype=arr.dtype, device=arr.device)
        self.arr = arr

    def __getitem__(self, idx):
        return self.arr[idx]

    def __len__(self):
        return self.arr.shape[0]

    def NumPy(self):
        return self.arr.detach().cpu().numpy()

    def __add__(self, o):
        return self.arr + _a(o)

    def __sub__(self, o):
        return self.arr - _a(o)


def _a(o):
    if isinstance(o, (VecShim, StandaloneVec)):
        return o.data
    return o


class GridFunction(CF):
    """GridFunction on a scalar or vector space, a ``Compress``ed one, an
    ``XFESpace``, a space-time, facet, HDiv or SFE space, or a compound of
    them.  Its vector lives on ``device``
    (default: the space's device, the card unless the caller asks for the
    CPU; without a card and without that argument it raises) in ``dtype``
    (default ``config.dtype``)."""

    def __init__(self, space, name="gf", device=None, dtype=None,
                 _parent=None, _block=None):
        from .hdiv import HDiv
        from .sfespace import SFESpace
        from .xfespace import XFESpace
        from ..spacetime.space import SpaceTimeFESpace

        if not isinstance(space, (FESpace, CompoundFESpace, XFESpace,
                                  SpaceTimeFESpace, HDiv, SFESpace)):
            raise TypeError(f"GridFunction on {type(space).__name__}")
        self.space = space
        self.name = name
        self._parent = _parent
        self._block = _block
        vd = getattr(space, "vdim", 1)
        self.dims = () if vd == 1 else (vd,)
        if _parent is None:
            self.device = resolve_device(device if device is not None
                                         else space._device)
            self.dtype = config.dtype if dtype is None else dtype
            self._array = torch.zeros(space.ndof, dtype=self.dtype,
                                      device=self.device)
        else:
            self.device, self.dtype = _parent.device, _parent.dtype
        if isinstance(space, CompoundFESpace):
            self.components = tuple(
                GridFunction(s, name=f"{name}.{i}", _parent=self, _block=i)
                for i, s in enumerate(space.components))
        else:
            self.components = ()

    # -- dof vector ---------------------------------------------------------
    @property
    def _arr(self):
        if self._parent is not None:
            return self._parent._array[self._parent.space.Range(self._block)]
        return self._array

    def _set_array(self, v):
        v = torch.as_tensor(v, dtype=self.dtype, device=self.device)
        if v.shape != (self.space.ndof,):
            raise ValueError(f"vector of shape {tuple(v.shape)} for "
                             f"{self.space.ndof} dofs")
        if self._parent is not None:
            with torch.no_grad():
                self._arr.copy_(v)
        else:
            self._array = v

    @property
    def vec(self):
        return VecShim(self) if self._parent is None else _CompVecShim(self)

    @vec.setter
    def vec(self, v):
        self._set_array(_a(v))

    # -- interpolation ------------------------------------------------------
    def Set(self, cf, boundary=False, definedonelements=None, BND=None):
        """Nodal interpolation of `cf` (NGSolve ``GridFunction.Set``
        analog): `cf` evaluated at each dof's Lagrange node.  With
        ``boundary`` only the dofs on the mesh boundary are set, with
        ``definedonelements`` only the dofs of the marked elements."""
        sp = self.space
        if isinstance(sp, CompoundFESpace):
            raise TypeError("Set on compound GF: use components")
        from ..spacetime.space import SpaceTimeFESpace

        if isinstance(sp, SpaceTimeFESpace):
            # reference semantics (spacetime/py_demos/set_test.py): Set on a
            # space-time GF interpolates spatially at each active time node
            # (tref fixed to the node's value) into the time-major blocks
            from ..spacetime.space import TimeFixedCF

            tmp = GridFunction(sp.spacefes, device=self.device,
                               dtype=self.dtype)
            arr = self._arr.clone()
            for i, ti in enumerate(sp.tfe.nodes):
                tmp.Set(TimeFixedCF(cf, float(ti)), boundary=boundary,
                        definedonelements=definedonelements, BND=BND)
                arr[i * sp.ndof_s:(i + 1) * sp.ndof_s] = tmp._arr
            self._set_array(arr)
            return
        scal = sp.scalar if isinstance(sp, VectorFESpace) else sp
        ref = torch.as_tensor(scal.dof_rep_ref, dtype=self.dtype,
                              device=self.device)[:, None, :]
        ids = torch.as_tensor(scal.dof_rep_elem, dtype=torch.int64,
                              device=self.device)
        ctx = EvalCtx(sp.mesh, ref, elem_ids=ids)
        vals = eval_pure(wrap(cf), ctx)
        if isinstance(sp, VectorFESpace):  # block layout
            new = torch.broadcast_to(vals, (scal.ndof, 1, sp.vdim))[:, 0]
            new = new.T.reshape(-1)
        else:
            new = torch.broadcast_to(vals, (sp.ndof, 1))[:, 0]
        keep = None
        if boundary or BND:
            keep = sp.bc_of_dof > 0
        if definedonelements is not None:
            m = GetDofsOfElements(sp, definedonelements).np
            keep = m if keep is None else keep & m
        if keep is not None:
            new = torch.where(torch.as_tensor(keep, device=self.device), new,
                              self._arr)
        self._set_array(new)

    def Deriv(self):
        return GradGF(self)

    # -- CF evaluation ------------------------------------------------------
    def _eval_pure(self, ctx: EvalCtx):
        hook = getattr(self.space, "gf_eval_hook", None)
        if hook is not None:
            return hook(self, ctx)
        return gf_value(self, ctx.elem_ids, ctx.ref_pts)

    def __repr__(self):
        return f"GridFunction({self.space}, name={self.name})"


class GradGF(CF):
    def __init__(self, gf: GridFunction):
        self.gf = gf
        d = gf.space.mesh.dim
        vd = getattr(gf.space, "vdim", 1)
        self.dims = (d,) if vd == 1 else (vd, d)

    def _eval_pure(self, ctx: EvalCtx):
        _, gref = gf_ref_value_and_grad(self.gf, ctx.elem_ids, ctx.ref_pts)
        # push-forward: g_phys[c, g] = sum_d gref[c, d] Jinv[d, g]
        g = small_matmul(gref, ctx.Jinv)
        return g[..., 0, :] if len(self.dims) == 1 else g


def _elem_dofs(gf: GridFunction, elem_ids, offset=0):
    """Element dof values (E, ndl) read at ``offset + el2dof`` (a vector
    space's component block); the placeholder slots of a masked space
    (which would read dof ``offset``) are zeroed."""
    sp = gf.space
    if isinstance(sp, CompoundFESpace):
        raise TypeError("evaluate components of a compound GridFunction")
    e2d = sp.el2dof_on(gf.device)
    valid = sp.el2dof_valid_on(gf.device)
    if elem_ids is not None:
        e2d = e2d[elem_ids]
        valid = None if valid is None else valid[elem_ids]
    dofs = gf._arr[e2d + offset]
    return dofs if valid is None else torch.where(valid, dofs, 0.0)


def _component_dofs(gf: GridFunction, elem_ids):
    """[(E, ndl)] element dof values, one per vector component."""
    sp = gf.space
    vdim = getattr(sp, "vdim", 1)
    if vdim == 1:
        return [_elem_dofs(gf, elem_ids)]
    return [_elem_dofs(gf, elem_ids, c * sp.nscal) for c in range(vdim)]


def _points(gf, elem_ids, ref_pts):
    """``elem_ids`` and ``ref_pts`` as tensors on the device of ``gf``'s
    vector, numpy points in its dtype."""
    return (None if elem_ids is None
            else as_input(elem_ids, device=gf.device),
            as_input(ref_pts, gf._arr))


def gf_value(gf: GridFunction, elem_ids, ref_pts):
    """Value of gf at (elem, refpt) batches -> (E,Q) or (E,Q,vdim); the ids
    and points may be numpy."""
    elem_ids, ref_pts = _points(gf, elem_ids, ref_pts)
    sp = gf.space
    B = shapes(sp.mesh.et, sp.order, ref_pts)  # (E|1,Q,ndl)
    vals = [(B * dofs[:, None, :]).sum(-1)
            for dofs in _component_dofs(gf, elem_ids)]
    return vals[0] if len(vals) == 1 else torch.stack(vals, dim=-1)


def gf_ref_value_and_grad(gf: GridFunction, elem_ids, ref_pts, time=None):
    """(value (E,Q,vdim), ref-grad (E,Q,vdim,d)) of gf at ref points.

    A space-time GridFunction (the space-time mesh deformation of
    ``LevelSetMeshAdaptation_Spacetime``) is evaluated at each point's
    ``time``, (E, Q) or broadcastable to it, by contracting the time basis
    with its time-major dof blocks.  The ids, points and times may be
    numpy."""
    from ..spacetime.space import SpaceTimeFESpace

    elem_ids, ref_pts = _points(gf, elem_ids, ref_pts)
    time = None if time is None else as_input(time, ref_pts)
    sp = gf.space
    if isinstance(sp, SpaceTimeFESpace):
        return _st_ref_value_and_grad(gf, elem_ids, ref_pts, time)
    B = shapes(sp.mesh.et, sp.order, ref_pts)  # (E|1,Q,ndl)
    G = dshapes(sp.mesh.et, sp.order, ref_pts)  # (E|1,Q,ndl,d)
    vals, grads = [], []
    for dofs in _component_dofs(gf, elem_ids):
        vals.append((B * dofs[:, None, :]).sum(-1))  # (E,Q)
        grads.append((G * dofs[:, None, :, None]).sum(-2))  # (E,Q,d)
    return torch.stack(vals, dim=-1), torch.stack(grads, dim=-2)


def _st_ref_value_and_grad(gf, elem_ids, ref_pts, time):
    """``gf_ref_value_and_grad`` of a space-time GridFunction."""
    if time is None:
        raise ValueError(
            "space-time GridFunction evaluated without a time context "
            "(use time_order>=0 integrals or RestrictGFInTime first)")
    sp = gf.space
    ssp = sp.spacefes
    vec = gf._arr
    vdim = getattr(ssp, "vdim", 1)
    e2d = ssp.el2dof_on(gf.device)
    if elem_ids is not None:
        e2d = e2d[elem_ids]
    B = shapes(ssp.mesh.et, ssp.order, ref_pts)  # (E|1,Q,ndl)
    G = dshapes(ssp.mesh.et, ssp.order, ref_pts)  # (E|1,Q,ndl,d)
    E, Q = e2d.shape[0], ref_pts.shape[1]
    Bt = sp.tfe.eval(torch.broadcast_to(time, (E, Q)).to(vec.dtype))
    nscal = ssp.nscal if vdim > 1 else 0
    vals, grads = [], []
    for c in range(vdim):
        v_c, g_c = 0.0, 0.0
        for t in range(sp.ndof_t):
            dofs = vec[t * sp.ndof_s + c * nscal + e2d]  # (E, ndl)
            v_c = v_c + Bt[..., t] * (B * dofs[:, None, :]).sum(-1)
            g_c = g_c + Bt[..., t, None] * (G * dofs[:, None, :, None]).sum(-2)
        vals.append(v_c)
        grads.append(g_c)
    return torch.stack(vals, dim=-1), torch.stack(grads, dim=-2)


def grad(obj):
    """grad() for GridFunctions and proxies (NGSolve-style free function)."""
    if isinstance(obj, GridFunction):
        from ..spacetime.space import SpaceTimeFESpace

        if isinstance(obj.space, SpaceTimeFESpace):
            from ..spacetime.space import STGFValueCF

            return STGFValueCF(obj, grad=True)
        return GradGF(obj)
    g = getattr(obj, "grad_op", None)
    if g is not None:
        return g()
    raise TypeError(f"grad() not supported for {type(obj)}")


@traced("InterpolateToP1")
def InterpolateToP1(levelset, gf_p1: GridFunction, eps_perturbation=None):
    """Vertex interpolation of a level set into a P1 GridFunction
    (cf. utils/p1interpol.hpp:25-37).  The epsilon-guard against exact zeros
    is applied later inside the cut kernels (ops/straightcut.py:eps_guard)."""
    sp = gf_p1.space
    if not isinstance(sp, H1) or sp.order != 1:
        raise TypeError("InterpolateToP1 target must be an order-1 H1 GridFunction")
    gf_p1.Set(wrap(levelset))
