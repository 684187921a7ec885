"""Quadrature-point evaluation context and pure-CF evaluator.

Counterpart of ``ngsxfem_tpu/cf/context.py``.  The context carries batched
geometry tensors for a set of elements and reference points — the analog of
NGSolve's ``MappedIntegrationRule`` that the reference evaluates coefficients
on (``cutint/python_cutint.cpp:57-64``).  Geometry is computed lazily, on
first use, on the device and in the dtype of the reference points.
"""
from __future__ import annotations

import torch

from ..config import as_input
from ..mesh.mesh import (geom_shapes, map_jacobian, pointwise_pow,
                         small_matmul, _det, _inv)
from . import coefficient as C


class EvalCtx:
    """Evaluation context of ``E`` elements x ``Q`` reference points.

    ``ref_pts`` is (E, Q, d), or (1, Q, d) for one point set shared by all
    elements; ``elem_ids`` (E,) int64 selects the elements (all of the mesh
    when None); ``nref`` (E, Q, d) is the reference-space unit normal of a
    cut interface rule; ``normal`` (E, Q, d) a given physical unit normal
    and ``facet_ids`` (E,) the facet of each row (facet loops).  A facet
    integral attaches the neighbour element's context as ``other_ctx``, on
    which ``u.Other()`` is evaluated.

    ``deformation`` is a vector GridFunction whose value is added to the
    geometry map (its reference gradient to ``J``), None for none, or
    ``"inherit"`` (the default) for the mesh's ``SetDeformation`` state, as
    the reference integrators' ``deformation`` argument
    (xfem/python_xfem.cpp:512-513).  Without a deformation ``J`` is
    (E, 1, d, d) on simplices (the affine map); with one it is (E, Q, d, d),
    and ``detJ``, ``Jinv``, ``h`` and the interface normal follow per point.

    ``time`` is the slab-reference time in [0, 1] of each point, a tensor
    broadcastable to (E, Q), or None outside a space-time integral: it is
    what ``tref``, space-time proxies and GridFunctions, and a space-time
    deformation are evaluated at.

    Each array argument may be numpy, as the reference's ``jnp`` ops take
    it: it becomes a tensor here, on the device of the tensors among them
    (else the current card), the normals and times in the points' dtype.
    """

    def __init__(self, mesh, ref_pts, elem_ids=None, nref=None, normal=None,
                 facet_ids=None, deformation="inherit", time=None):
        self.mesh = mesh
        self.deformation = (mesh.deformation if isinstance(deformation, str)
                            and deformation == "inherit" else deformation)
        ref_pts = as_input(ref_pts, next(
            (t for t in (nref, normal, time, elem_ids, facet_ids)
             if torch.is_tensor(t)), None))
        nref, normal, time = (None if t is None else as_input(t, ref_pts)
                              for t in (nref, normal, time))
        elem_ids, facet_ids = (
            None if t is None else as_input(t, device=ref_pts.device)
            for t in (elem_ids, facet_ids))
        self.ref_pts = ref_pts
        self.elem_ids = elem_ids
        self._nref = nref
        self._normal = normal
        self.facet_ids = facet_ids
        self.time = time
        self.other_ctx = None
        self._cache = {}
        self.E = mesh.ne if elem_ids is None else elem_ids.shape[0]
        self.Q = ref_pts.shape[1]
        self.dtype = ref_pts.dtype
        self.device = ref_pts.device

    # -- geometry -----------------------------------------------------------
    @property
    def elem_coords(self):
        def make():
            verts, els = self.mesh.device_view(self.device, self.dtype)
            return verts[els if self.elem_ids is None else els[self.elem_ids]]

        return self._cached("elem_coords", make)

    def _cached(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    def _displacement(self):
        """(value (E, Q, d), reference gradient (E, Q, d, d)) of the
        deformation at the context's points."""
        def make():
            from ..fem.gridfunction import gf_ref_value_and_grad

            val, grad = gf_ref_value_and_grad(self.deformation, self.elem_ids,
                                              self.ref_pts, time=self.time)
            return val.to(self.dtype), grad.to(self.dtype)

        return self._cached("displacement", make)

    @property
    def phys(self):
        def make():
            phys = small_matmul(geom_shapes(self.mesh.et, self.ref_pts),
                                self.elem_coords)
            if self.deformation is not None:
                phys = phys + self._displacement()[0]
            return phys

        return self._cached("phys", make)

    @property
    def J(self):
        """(E, Q, d, d); (E, 1, d, d) on simplices (affine map) without a
        deformation."""
        def make():
            J = map_jacobian(self.mesh.et, self.elem_coords, self.ref_pts)
            if self.deformation is not None:
                J = J + self._displacement()[1]
            return J

        return self._cached("J", make)

    @property
    def detJ(self):
        return self._cached("detJ", lambda: _det(self.J))

    @property
    def Jinv(self):
        return self._cached("Jinv", lambda: _inv(self.J, self.detJ))

    @property
    def absdetJ(self):
        return self.detJ.abs()

    @property
    def h(self):
        """NGSolve-like mesh size |det J|^(1/dim)."""
        return pointwise_pow(self.absdetJ, 1.0 / self.mesh.dim)

    def _jinvt_nref(self):
        """J^-T n_ref and its norm, shared by `normal` and `if_scale`."""
        def make():
            n = small_matmul(self._nref[..., None, :], self.Jinv)[..., 0, :]
            return n, torch.linalg.vector_norm(n, dim=-1)

        return self._cached("jinvt_nref", make)

    @property
    def normal(self):
        if self._normal is not None:
            return self._normal
        if self._nref is None:
            raise ValueError("no normal available in this context")
        n, nn = self._jinvt_nref()
        return n / torch.where(nn < 1e-30, 1.0, nn)[..., None]

    @property
    def if_scale(self):
        """co-area weight factor ||J^-T n_ref|| (interface rules)."""
        if self._nref is None:
            raise ValueError("if_scale needs a reference normal")
        return self._jinvt_nref()[1]


def eval_pure(cf, ctx: EvalCtx):
    """Evaluate a proxy-free CF -> tensor broadcastable to (E,Q)+cf.dims."""
    if isinstance(cf, (C.Constant, C.Parameter)):
        return torch.tensor(cf.value, dtype=ctx.dtype, device=ctx.device)
    if isinstance(cf, C.Coord):
        if cf.axis >= ctx.mesh.dim:
            return torch.zeros((), dtype=ctx.dtype, device=ctx.device)
        return ctx.phys[..., cf.axis]
    if isinstance(cf, C.Add):
        return eval_pure(cf.a, ctx) + eval_pure(cf.b, ctx)
    if isinstance(cf, C.Scale):
        return cf.s * eval_pure(cf.a, ctx)
    if isinstance(cf, C.Mul):
        a, b = eval_pure(cf.a, ctx), eval_pure(cf.b, ctx)
        if cf.a.dims == () and cf.b.dims != ():
            s = _bc(a, ctx).reshape((ctx.E, ctx.Q) + (1,) * len(cf.b.dims))
            return s * _full(b, ctx, cf.b.dims)
        if cf.b.dims == () and cf.a.dims != ():
            s = _bc(b, ctx).reshape((ctx.E, ctx.Q) + (1,) * len(cf.a.dims))
            return _full(a, ctx, cf.a.dims) * s
        return a * b
    if isinstance(cf, C.InnerProduct):
        a, b = eval_pure(cf.a, ctx), eval_pure(cf.b, ctx)
        if cf.a.dims == ():  # scalar InnerProduct == product
            return a * b
        # contract over ALL component axes (Frobenius for matrices)
        axes = tuple(range(-len(cf.a.dims), 0))
        return torch.sum(_full(a, ctx, cf.a.dims) * _full(b, ctx, cf.b.dims),
                         dim=axes)
    if isinstance(cf, C.MatVec):
        a = _full(eval_pure(cf.a, ctx), ctx, cf.a.dims)
        b = _full(eval_pure(cf.b, ctx), ctx, cf.b.dims)
        return torch.einsum("...ij,...j->...i", a, b)
    if isinstance(cf, C.Div):
        return eval_pure(cf.a, ctx) / eval_pure(cf.b, ctx)
    if isinstance(cf, C.Pow):
        return eval_pure(cf.a, ctx) ** cf.p
    if isinstance(cf, C.UnaryOp):
        return C.UnaryOp.FNS[cf.fname](eval_pure(cf.a, ctx))
    if isinstance(cf, C.Component):
        a = _full(eval_pure(cf.a, ctx), ctx, cf.a.dims)
        return a[..., cf.idx] if len(cf.a.dims) == 1 else a[..., cf.idx, :]
    if isinstance(cf, C.VectorCF):
        cols = []
        for c in cf.comps:
            v = _full(eval_pure(c, ctx), ctx, c.dims)
            cols.append(v[..., None] if c.dims == () else v)
        return torch.cat(cols, dim=-1)
    if isinstance(cf, C.Reshaped):
        a = _full(eval_pure(cf.child, ctx), ctx, cf.child.dims)
        return a.reshape(a.shape[: a.ndim - len(cf.child.dims)] + cf.dims)
    if isinstance(cf, C.NormCF):
        a = _full(eval_pure(cf.a, ctx), ctx, cf.a.dims)
        if cf.a.dims == ():
            return a.abs()
        # Frobenius norm over ALL component axes (vector or matrix)
        axes = tuple(range(-len(cf.a.dims), 0))
        return torch.sqrt(torch.sum(a * a, dim=axes))
    if isinstance(cf, C.IfPosCF):
        c = _bc(eval_pure(cf.c, ctx), ctx)
        a = _full(eval_pure(cf.a, ctx), ctx, cf.a.dims)
        b = _full(eval_pure(cf.b, ctx), ctx, cf.b.dims)
        if cf.dims != ():
            c = c[..., None]
        return torch.where(c > 0, a, b)
    if isinstance(cf, C.SpecialCF):
        if cf.kind == "mesh_size":
            return ctx.h
        if cf.kind == "normal":
            return ctx.normal
        raise NotImplementedError(f"specialcf.{cf.kind}")
    if isinstance(cf, C.ElementValuesCF):
        v = torch.as_tensor(cf.values, device=ctx.device)
        if ctx.elem_ids is not None:
            v = v[ctx.elem_ids]
        return v[:, None].to(ctx.dtype)
    if isinstance(cf, C.FacetValuesCF):
        if ctx.facet_ids is None:
            raise ValueError("facet-valued CF evaluated outside a facet loop")
        v = torch.as_tensor(cf.values, device=ctx.device)
        return v[ctx.facet_ids][:, None].to(ctx.dtype)
    # GridFunction evaluation is handled by its own hook
    ev = getattr(cf, "_eval_pure", None)
    if ev is not None:
        return ev(ctx)
    raise NotImplementedError(f"cannot evaluate {type(cf).__name__}")


def _bc(a, ctx):
    """broadcast scalar-ish tensor to (E,Q)."""
    return torch.broadcast_to(a, (ctx.E, ctx.Q))


def _full(a, ctx, dims):
    return torch.broadcast_to(a, (ctx.E, ctx.Q) + dims)
