"""Bilinear-jet form evaluation.

Counterpart of ``ngsxfem_tpu/forms/evaluate.py``.  Where
NGSolve's symbolic framework linearizes integrands w.r.t. proxies by
repeated evaluation (``xfem/symboliccutbfi.cpp:151-215``), a *bilinear jet*
is propagated through the CF graph in one pass: every value is a sum of
terms ``scalar * cfree (x) (u-factor) (x) (v-factor)`` with factor tensors
carrying the element-dof axis.  The element matrix then falls out as one
contraction per term (forms/assemble.py).

Tensors broadcast: a factor's element axis is 1 where one set of reference
points serves every element, and its point axis is 1 where the geometry is
constant on the element.  Contractions over the tiny component axes are
broadcast multiply-sums (a batch of tiny matmuls runs as a library GEMM on
the card, several times the cost of an elementwise product).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from math import factorial
from typing import Optional

import numpy as np
import torch

from ..cf import coefficient as C
from ..cf.context import EvalCtx, eval_pure, _full, _bc
from ..fem.basis import shapes, dshapes
from ..mesh.mesh import small_matmul
from .proxies import ProxyFunction


@dataclass
class Factor:
    block: tuple  # (compound block index, other flag)
    arr: torch.Tensor  # (E, Q, ndof_el, *comps)
    space: object  # the (component) FESpace this factor belongs to


@dataclass
class Term:
    scalar: torch.Tensor  # broadcastable to (E, Q)
    cfree: Optional[torch.Tensor] = None  # (E, Q, *S) free comps on coefficient
    ufac: Optional[Factor] = None
    vfac: Optional[Factor] = None
    contracted: bool = False  # ufac/vfac trailing axis contracted pairwise

    def comp_loc(self):
        if self.cfree is not None:
            return "c"
        if self.contracted:
            return None
        if self.ufac is not None and self.ufac.arr.ndim > 3:
            return "u"
        if self.vfac is not None and self.vfac.arr.ndim > 3:
            return "v"
        return None

    def comps(self):
        loc = self.comp_loc()
        if loc == "c":
            return tuple(self.cfree.shape[2:])
        if loc == "u":
            return tuple(self.ufac.arr.shape[3:])
        if loc == "v":
            return tuple(self.vfac.arr.shape[3:])
        return ()


def term_mul(t1: Term, t2: Term, c: int) -> Term:
    if t1.ufac is not None and t2.ufac is not None:
        raise TypeError("form is nonlinear in the trial function")
    if t1.vfac is not None and t2.vfac is not None:
        raise TypeError("form is nonlinear in the test function")
    scalar = t1.scalar * t2.scalar
    if c == 0:
        cfree = t1.cfree if t1.cfree is not None else t2.cfree
        if t1.cfree is not None and t2.cfree is not None:
            raise TypeError("product of two component-valued terms without contraction")
        return Term(
            scalar=scalar,
            cfree=cfree,
            ufac=t1.ufac or t2.ufac,
            vfac=t1.vfac or t2.vfac,
            contracted=t1.contracted or t2.contracted,
        )

    loc1, loc2 = t1.comp_loc(), t2.comp_loc()
    S1, S2 = t1.comps(), t2.comps()
    if loc1 is None or loc2 is None:
        raise TypeError("contraction with a scalar term")
    keep1, keep2 = S1[: len(S1) - c], S2[: len(S2) - c]
    if S1[len(S1) - c:] != S2[len(S2) - c:]:
        raise TypeError(f"contraction dims mismatch {S1} vs {S2}")

    def get(t, loc):
        return t.cfree if loc == "c" else (t.ufac.arr if loc == "u" else t.vfac.arr)

    a1, a2 = get(t1, loc1), get(t2, loc2)

    # flatten: free dims then contracted axis
    def prep(a, has_dof):
        # a: (E,Q,[n],*keep,*con) -> (E,Q,[n],K,X)
        base = 3 if has_dof else 2
        keep = tuple(a.shape[base: a.ndim - c])
        kn = int(np.prod(keep)) if keep else 1
        xn = int(np.prod(a.shape[a.ndim - c:]))
        return a.reshape(tuple(a.shape[:base]) + (kn, xn)), keep

    has1, has2 = loc1 != "c", loc2 != "c"
    f1, keep_sh1 = prep(a1, has1)
    f2, keep_sh2 = prep(a2, has2)

    if loc1 != "c" and loc2 != "c":
        # u-v contraction: must be full (scalar result)
        if keep1 or keep2:
            raise TypeError("partial u-v contraction unsupported; expand the form")
        arr1 = f1[..., 0, :]  # (E,Q,n,X)
        arr2 = f2[..., 0, :]
        new1 = replace(t1.ufac or t1.vfac, arr=arr1)
        new2 = replace(t2.ufac or t2.vfac, arr=arr2)
        ufac = new1 if loc1 == "u" else new2
        vfac = new1 if loc1 == "v" else new2
        return Term(scalar=scalar, ufac=ufac, vfac=vfac, contracted=True)

    # coefficient on one side: absorb contraction into the other carrier
    if loc1 == "c" and loc2 == "c":
        # "eqkx,eqlx->eqkl"
        out = (f1[..., :, None, :] * f2[..., None, :, :]).sum(-1)
        out = out.reshape(tuple(out.shape[:2]) + keep_sh1 + keep_sh2)
        if out.ndim == 2:
            return Term(scalar=scalar * out, ufac=t1.ufac or t2.ufac,
                        vfac=t1.vfac or t2.vfac,
                        contracted=t1.contracted or t2.contracted)
        return Term(scalar=scalar, cfree=out, ufac=t1.ufac or t2.ufac,
                    vfac=t1.vfac or t2.vfac,
                    contracted=t1.contracted or t2.contracted)
    # one factor-carried, one coefficient-carried
    if loc1 == "c":
        fc, kc = f1, keep_sh1
        ff, kf = f2, keep_sh2
        tf, locf = t2, loc2
        order = "cf"
    else:
        ff, kf = f1, keep_sh1
        fc, kc = f2, keep_sh2
        tf, locf = t1, loc1
        order = "fc"
    # "eqnkx,eqlx->eqnkl"
    out = (ff[..., :, None, :] * fc[:, :, None, None, :, :]).sum(-1)
    # free dims order: S1-keeps then S2-keeps
    if order == "cf":
        out = out.transpose(-1, -2)
        keeps = kc + kf
    else:
        keeps = kf + kc
    out = out.reshape(tuple(out.shape[:3]) + keeps)
    fac = replace(tf.ufac if locf == "u" else tf.vfac, arr=out)
    return Term(
        scalar=scalar,
        ufac=fac if locf == "u" else (t1.ufac or t2.ufac),
        vfac=fac if locf == "v" else (t1.vfac or t2.vfac),
        contracted=t1.contracted or t2.contracted,
    )


# ---------------------------------------------------------------------------
# proxy basis factors


def _vec_expand(arr, vdim):
    """(E,Q,ndl,*rest) scalar-basis factor -> (E,Q,vdim*ndl,vdim,*rest) in
    the block layout of a vector space (component c on rows c*ndl..)."""
    E, Q, n = arr.shape[:3]
    rest = tuple(arr.shape[3:])
    out = arr.new_zeros((E, Q, vdim, n, vdim) + rest)
    for c in range(vdim):
        out[:, :, c, :, c] = arr
    return out.reshape((E, Q, vdim * n, vdim) + rest)


def proxy_factor(proxy: ProxyFunction, ctx: EvalCtx) -> Factor:
    pctx = ctx
    if proxy.other:
        if ctx.other_ctx is None:
            raise TypeError(".Other() used outside a facet integral")
        pctx = ctx.other_ctx
    sp = proxy.space
    # XFESpace (sign-masked enrichment) evaluates through its own hook
    xhook = getattr(sp, "proxy_factor_hook", None)
    if xhook is not None:
        return xhook(proxy, ctx, pctx)
    et, order = sp.mesh.et, sp.order
    vdim = getattr(sp, "vdim", 1)
    if proxy.op == "val":
        arr = shapes(et, order, pctx.ref_pts)
    elif proxy.op in ("grad", "div"):
        G = dshapes(et, order, pctx.ref_pts)  # (E|1,Q,ndl,d)
        arr = small_matmul(G, pctx.Jinv)  # "eqid,eqdg->eqig"
        if proxy.op == "div":
            if vdim != sp.mesh.dim:
                raise TypeError("div needs a vector space with vdim == mesh.dim")
            # the trace of the block-expanded gradient: component c's
            # rows carry d(phi)/dx_c
            arr = torch.cat([arr[..., c] for c in range(vdim)], dim=2)
            return Factor(block=proxy.block_key, arr=arr, space=sp)
    elif proxy.op == "dnk":
        arr = _dnk_factor(et, order, proxy.op_args[0], pctx)
    else:
        raise NotImplementedError(f"proxy op {proxy.op}")
    if vdim != 1:
        arr = _vec_expand(arr, vdim)
    return Factor(block=proxy.block_key, arr=arr, space=sp)


def _dnk_factor(et, order, k, ctx: EvalCtx):
    """Exact k-th directional derivative of all shapes along the facet
    normal: the basis restricted to the line x + t*n is a 1D polynomial of
    degree <= order, so sampling it at order+1 Chebyshev nodes and
    differentiating the interpolant is exact (where the reference uses
    central FD stencils, xfem/ghostpenalty.cpp:8-130)."""
    p = order
    n = ctx.normal  # (E,Q,d) physical unit normal
    # chain rule direction "eqdg,eqg->eqd"
    dir_ref = small_matmul(ctx.Jinv, n[..., None])[..., 0]
    tn = np.cos(np.pi * (2 * np.arange(p + 1) + 1) / (2 * (p + 1)))
    V = np.vander(tn, increasing=True)  # V[i,j] = t_i^j
    wk = factorial(k) * np.linalg.inv(V)[k]  # (p+1,)
    # sample along the UNIT reference direction, so that the nodes stay
    # O(1) inside the element, and rescale by |dir_ref|^k after (raw
    # t*dir_ref puts them O(1/h) outside, where the Vandermonde
    # differentiation cancels catastrophically)
    dnrm = torch.linalg.vector_norm(dir_ref, dim=-1, keepdim=True)  # (E,Q,1)
    step = dir_ref / dnrm.clamp_min(1e-30)
    t = torch.as_tensor(tn, dtype=step.dtype, device=step.device)
    pts = ctx.ref_pts[:, :, None, :] + t[None, None, :, None] * step[:, :, None, :]
    S = shapes(et, order, pts)  # (E,Q,p+1,ndl)
    out = 0.0
    for i, w in enumerate(wk.tolist()):  # "t,eqti->eqi"
        out = out + w * S[:, :, i, :]
    return out * dnrm**k


# ---------------------------------------------------------------------------
# the evaluator


def eval_form(cf, ctx: EvalCtx):
    """CF graph -> list of bilinear-jet Terms."""
    one = torch.ones((), dtype=ctx.dtype, device=ctx.device)
    if not cf.has_proxy:
        v = eval_pure(cf, ctx)
        if cf.dims == ():
            return [Term(scalar=_bc(v, ctx))]
        return [Term(scalar=one, cfree=_full(v, ctx, cf.dims))]

    if isinstance(cf, ProxyFunction):
        fac = proxy_factor(cf, ctx)
        return [Term(scalar=one, vfac=fac) if cf.test
                else Term(scalar=one, ufac=fac)]

    if isinstance(cf, C.Add):
        return eval_form(cf.a, ctx) + eval_form(cf.b, ctx)
    if isinstance(cf, C.Scale):
        return [replace(t, scalar=cf.s * t.scalar) for t in eval_form(cf.a, ctx)]
    if isinstance(cf, C.Mul):
        return _prod(cf.a, cf.b, ctx, 0)
    if isinstance(cf, C.InnerProduct):
        return _prod(cf.a, cf.b, ctx, len(cf.a.dims))
    if isinstance(cf, C.MatVec):
        return _prod(cf.a, cf.b, ctx, 1)
    if isinstance(cf, C.Div):
        if cf.b.has_proxy:
            raise TypeError("division by a proxy expression")
        inv = 1.0 / _bc(eval_pure(cf.b, ctx), ctx)
        return [replace(t, scalar=t.scalar * inv) for t in eval_form(cf.a, ctx)]
    if isinstance(cf, C.Component):
        terms = eval_form(cf.a, ctx)
        return [_component(t, cf.idx) for t in terms]

    raise NotImplementedError(
        f"proxy expression through {type(cf).__name__} is not supported"
    )


def _prod(a, b, ctx, c):
    ta, tb = eval_form(a, ctx), eval_form(b, ctx)
    return [term_mul(t1, t2, c) for t1 in ta for t2 in tb]


def _component(t: Term, idx: int) -> Term:
    """Index the leading free component dim of a term."""
    loc = t.comp_loc()
    if loc == "c":
        c = t.cfree[:, :, idx]
        if c.ndim == 2:  # became scalar
            return replace(t, cfree=None, scalar=t.scalar * c)
        return replace(t, cfree=c)
    if loc == "u":
        return replace(t, ufac=replace(t.ufac, arr=t.ufac.arr[:, :, :, idx]))
    if loc == "v":
        return replace(t, vfac=replace(t.vfac, arr=t.vfac.arr[:, :, :, idx]))
    raise TypeError("component of scalar term")
