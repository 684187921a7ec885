"""Space-time tensor-product FE spaces, diff-ops and time-restriction utils.

Counterpart of ``ngsxfem_tpu/spacetime/space.py`` (the reference's
``spacetime/SpaceTimeFESpace.*``, ``diffopDt.*``, ``timecf.*`` and
``python_spacetime.cpp``): the space is the tensor product of a spatial
space with a time FE, its dofs time-major (the spatial dofs of time node t
at offset ``t * ndof_s``, SpaceTimeFESpace.cpp:109-122), and a basis
evaluation is one outer product of the time basis with the spatial basis at
the context's explicit ``time`` tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from ..cf.coefficient import CF, wrap
from ..fem.space import BitArray, DeviceViews
from ..fem.basis import shapes, dshapes
from ..mesh.mesh import small_matmul
from ..utils.timing import traced
from .timefe import ScalarTimeFE


class SpaceTimeFESpace(DeviceViews):
    """V_space (x) P_k(time); ndof = ndof_space * ndof_time.  Lives on the
    device of its spatial space."""

    vdim = 1

    def __init__(self, spacefes, timefe: ScalarTimeFE, dirichlet=None,
                 dgjumps=False, **kw):
        self.spacefes = spacefes
        self.tfe = timefe
        self.mesh = spacefes.mesh
        self.order = spacefes.order
        self.order_time = timefe.order
        self.ndof_t = timefe.ndof
        self.ndof_s = spacefes.ndof
        self.ndof = self.ndof_s * self.ndof_t
        maps = [spacefes.el2dof_np + t * self.ndof_s for t in range(self.ndof_t)]
        self.el2dof_np = np.concatenate(maps, axis=1).astype(np.int32)
        # its own dirichlet spec (the reference binding accepts one,
        # spacetime/python_spacetime.cpp:46-68) joins the spatial one
        sdiri = spacefes.dirichlet_dofs
        if dirichlet is not None:
            sdiri = sdiri | spacefes._dirichlet_mask(dirichlet)
        self.dirichlet_dofs = np.tile(sdiri, self.ndof_t)
        self.bc_of_dof = np.tile(spacefes.bc_of_dof, self.ndof_t)
        self.dgjumps = dgjumps
        self._device = spacefes._device
        self._views = {}
        self._fixed_time = None
        self._override_time = False

    @property
    def k_t(self):
        return self.order_time

    def TimeFE_nodes(self):
        return list(self.tfe.nodes)

    def IsTimeNodeActive(self, i):
        return self.tfe.IsNodeActive(i)

    def SetTime(self, t):
        """Fix the time for later GridFunction evaluations (reference
        SpaceTimeFESpace::SetTime); applies where no time context is given,
        or always after SetOverrideTime(True)."""
        self._fixed_time = None if t is None else float(t)

    def SetOverrideTime(self, override: bool):
        """Make SetTime's value override the integrator's time too
        (reference SpaceTimeFESpace::SetOverrideTime)."""
        self._override_time = bool(override)

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

    # -- proxy evaluation -----------------------------------------------------
    def _time_basis(self, proxy, pctx, deriv=False):
        if proxy.op_args and proxy.op.startswith("fix"):
            t = torch.full((pctx.E, pctx.Q), float(proxy.op_args[0]),
                           dtype=pctx.dtype, device=pctx.device)
        else:
            if pctx.time is None:
                raise ValueError(
                    "space-time proxy evaluated without a time context; "
                    "use time_order>=0 integrals or fix_t")
            t = torch.broadcast_to(pctx.time, (pctx.E, pctx.Q))
        return self.tfe.deval(t) if deriv else self.tfe.eval(t)

    def proxy_factor_hook(self, proxy, ctx, pctx):
        from ..forms.evaluate import Factor

        et, ks = self.mesh.et, self.order
        op = proxy.op
        E, Q = pctx.E, pctx.Q
        if op in ("val", "fixt", "dt", "fixtdt"):
            Bs = shapes(et, ks, pctx.ref_pts)  # (E|1,Q,ndl)
            Bt = self._time_basis(proxy, pctx, deriv=op in ("dt", "fixtdt"))
            # "eqt,eqi->eqti"
            arr = (Bt[..., :, None] * Bs[..., None, :]).reshape(
                E, Q, Bt.shape[-1] * Bs.shape[-1])
        elif op in ("grad", "fixtgrad"):
            Gp = small_matmul(dshapes(et, ks, pctx.ref_pts), pctx.Jinv)
            Bt = self._time_basis(proxy, pctx)
            # "eqt,eqig->eqtig"
            arr = (Bt[..., :, None, None] * Gp[..., None, :, :]).reshape(
                E, Q, Bt.shape[-1] * Gp.shape[-2], self.mesh.dim)
        else:
            raise NotImplementedError(f"space-time proxy op {op}")
        return Factor(block=proxy.block_key, arr=arr, space=self)

    # -- GridFunction evaluation ----------------------------------------------
    def gf_eval_hook(self, gf, ctx, grad=False, deriv_t=False, fixed_time=None):
        vec = gf._arr
        ssp = self.spacefes
        vdim = getattr(ssp, "vdim", 1)
        if fixed_time is None and self._fixed_time is not None and (
                self._override_time or ctx.time is None):
            fixed_time = self._fixed_time  # SetTime / SetOverrideTime state
        if fixed_time is not None:
            t = torch.full((ctx.E, ctx.Q), float(fixed_time), dtype=ctx.dtype,
                           device=ctx.device)
        else:
            if ctx.time is None:
                raise ValueError("space-time GridFunction needs a time context"
                                 " (or SpaceTimeFESpace.SetTime)")
            t = torch.broadcast_to(ctx.time, (ctx.E, ctx.Q))
        Bt = (self.tfe.deval(t) if deriv_t else self.tfe.eval(t)).to(vec.dtype)
        Bs = None if grad else shapes(self.mesh.et, self.order, ctx.ref_pts)
        G = dshapes(self.mesh.et, self.order, ctx.ref_pts) if grad else None
        e2d = ssp.el2dof_on(vec.device)
        if ctx.elem_ids is not None:
            e2d = e2d[ctx.elem_ids]
        nscal = ssp.nscal if vdim > 1 else 0
        toffs = torch.arange(self.ndof_t, device=vec.device) * self.ndof_s
        outs = []
        for c in range(vdim):
            # time block t's component c sits at t*ndof_s + c*nscal
            dofs = vec[toffs[None, :, None] + c * nscal + e2d[:, None, :]]
            if grad:
                # "eqt,eqid,eti->eqd", then the push-forward
                H = small_matmul(dofs[:, None], G)  # (E,Q,ndt,d)
                gref = (Bt[..., None] * H).sum(-2)
                outs.append(small_matmul(gref[..., None, :], ctx.Jinv)[..., 0, :])
            else:
                # "eqt,eqi,eti->eq"
                S = small_matmul(Bs, dofs.transpose(-1, -2))  # (E,Q,ndt)
                outs.append((S * Bt).sum(-1))
        if vdim == 1:
            return outs[0]
        return torch.stack(outs, dim=-2 if grad else -1)

    @traced("RestrictGFInTime")
    def RestrictGFInTime(self, spacetime_gf, reference_time, space_gf):
        vec = spacetime_gf._arr.reshape(self.ndof_t, self.ndof_s)
        bt = torch.as_tensor(
            self.tfe.eval_np(np.array([reference_time]))[0], dtype=vec.dtype,
            device=vec.device)
        space_gf._set_array((bt[:, None] * vec).sum(0))

    def __repr__(self):
        return (f"SpaceTimeFESpace(ndof={self.ndof} = {self.ndof_s} x "
                f"{self.ndof_t}, k_t={self.k_t})")


# -- CF nodes ---------------------------------------------------------------


class TimeVariableCF(CF):
    """tref in [0,1] (cf. spacetime/timecf.hpp TimeVariableCoefficientFunction).

    ``FixTime``/``UnfixTime``/``IsFixed`` mirror the reference's mutable
    fixed-time state (spacetime/timecf.cpp:26-32): while fixed, the CF
    evaluates to the fixed value even outside a time context."""

    dims = ()

    def __init__(self):
        self._fixed_time = None

    def FixTime(self, time):
        self._fixed_time = float(time)

    def UnfixTime(self):
        self._fixed_time = None

    def IsFixed(self):
        return self._fixed_time is not None

    def _eval_pure(self, ctx):
        if self._fixed_time is not None:
            return torch.full((ctx.E, ctx.Q), self._fixed_time,
                              dtype=ctx.dtype, device=ctx.device)
        if ctx.time is None:
            raise ValueError("ReferenceTimeVariable evaluated without time context")
        return torch.broadcast_to(ctx.time, (ctx.E, ctx.Q))


def ReferenceTimeVariable():
    return TimeVariableCF()


tref = TimeVariableCF()


class TimeFixedCF(CF):
    """Evaluate a (time-dependent) CF at a fixed reference time."""

    def __init__(self, child, t):
        self.child = wrap(child)
        self.t = float(t)
        self.dims = self.child.dims

    def children(self):
        return (self.child,)

    def _eval_pure(self, ctx):
        from ..cf.context import EvalCtx, eval_pure

        sub = EvalCtx(ctx.mesh, ctx.ref_pts, elem_ids=ctx.elem_ids,
                      nref=ctx._nref, normal=ctx._normal,
                      facet_ids=ctx.facet_ids,
                      deformation=ctx.deformation,  # keep the context's own
                      time=torch.full((ctx.E, ctx.Q), self.t, dtype=ctx.dtype,
                                      device=ctx.device))
        return eval_pure(self.child, sub)


class STGFValueCF(CF):
    """Value / spatial gradient / dt of a space-time GridFunction."""

    def __init__(self, gf, grad=False, deriv_t=False, fixed_time=None):
        self.gf = gf
        self.grad = grad
        self.deriv_t = deriv_t
        self.fixed_time = fixed_time
        vdim = getattr(gf.space.spacefes, "vdim", 1)
        d = gf.space.mesh.dim
        if grad:
            self.dims = (d,) if vdim == 1 else (vdim, d)
        else:
            self.dims = () if vdim == 1 else (vdim,)

    def _eval_pure(self, ctx):
        return self.gf.space.gf_eval_hook(
            self.gf, ctx, grad=self.grad, deriv_t=self.deriv_t,
            fixed_time=self.fixed_time)


def dt(u):
    """Time derivative with respect to tref (reference diffopDt.hpp
    DiffOpDt)."""
    from ..forms.proxies import ProxyFunction
    from ..fem.gridfunction import GridFunction

    if isinstance(u, ProxyFunction):
        if not isinstance(u.space, SpaceTimeFESpace):
            raise TypeError("dt needs a space-time function")
        if u.op != "val":
            # dt(grad(u)) / dt(dt(u)) have no diff-op here (nor in the
            # reference, diffopDt.hpp applies to the value): raising beats
            # silently dropping the inner operator
            raise NotImplementedError(
                f"dt of a '{u.op}' proxy is not supported; apply dt to the "
                "plain function")
        return u._clone(op="dt", dims=())
    if isinstance(u, GridFunction) and isinstance(u.space, SpaceTimeFESpace):
        return STGFValueCF(u, deriv_t=True)
    raise TypeError("dt expects a space-time proxy or GridFunction")


def dt_vec(u):
    """Vector variant of dt (reference DiffOpDtVec): the componentwise time
    derivative, the same as dt in the tensor-product construction."""
    return dt(u)


def fix_t(u, time):
    """Trace at a fixed reference time (reference DiffOpFixt / fix_t)."""
    from ..forms.proxies import ProxyFunction
    from ..fem.gridfunction import GridFunction

    if isinstance(u, ProxyFunction):
        if not isinstance(u.space, SpaceTimeFESpace):
            raise TypeError("fix_t needs a space-time function")
        op = {"grad": "fixtgrad", "val": "fixt", "dt": "fixtdt"}.get(u.op)
        if op is None:
            raise NotImplementedError(
                f"fix_t of a '{u.op}' proxy is not supported")
        return u._clone(op=op, op_args=(float(time),))
    if isinstance(u, GridFunction) and isinstance(u.space, SpaceTimeFESpace):
        return STGFValueCF(u, fixed_time=float(time))
    if isinstance(u, CF):
        return TimeFixedCF(u, time)
    raise TypeError("fix_t expects a space-time function or CF")


def CreateTimeRestrictedGF(gf_st, reference_time=0.0):
    from ..fem.gridfunction import GridFunction

    sp = gf_st.space
    out = GridFunction(sp.spacefes, name=f"{gf_st.name}@t={reference_time}",
                       device=gf_st.device, dtype=gf_st.dtype)
    sp.RestrictGFInTime(gf_st, reference_time, out)
    return out


def RestrictGFInTime(spacetime_gf=None, reference_time=0.0, space_gf=None):
    spacetime_gf.space.RestrictGFInTime(spacetime_gf, reference_time, space_gf)


@traced("SpaceTimeInterpolateToP1")
def SpaceTimeInterpolateToP1(levelset, tref_var, gf_st):
    """Interpolate a time-dependent level set into a space-time P1
    GridFunction, node by node in time (cf.
    SpaceTimeFESpace::InterpolateToP1, SpaceTimeFESpace.cpp:202-230)."""
    sp = gf_st.space
    if not isinstance(sp, SpaceTimeFESpace) or sp.spacefes.order != 1:
        raise TypeError("target must be a space-time GF over H1(order=1)")
    from ..fem.gridfunction import GridFunction

    blocks = []
    tmp = GridFunction(sp.spacefes, device=gf_st.device, dtype=gf_st.dtype)
    for tn in sp.tfe.nodes:
        tmp.Set(TimeFixedCF(levelset, float(tn)))
        blocks.append(tmp._arr)
    gf_st._set_array(torch.cat(blocks))
