"""Trial/test proxy functions and their differential operators.

Counterpart of ``ngsxfem_tpu/forms/proxies.py`` (the replacement for
NGSolve's symbolic proxy framework that the reference's cut integrators plug
into, ``xfem/symboliccutbfi.cpp:151-215``): a proxy evaluates to a *basis
factor tensor* ``(E, Q, ndof_el, *comps)``; form evaluation propagates
bilinear jets (forms/evaluate.py).  Ported: value and gradient proxies and
``.Other()``.  ``dn``, ``dnjump``, ``div`` and ``Operator`` raise
``NotImplementedError`` (ROADMAP A9b).
"""
from __future__ import annotations

from ..cf.coefficient import CF


class ProxyFunction(CF):
    """Value proxy of a trial (test=False) or test (test=True) function."""

    def __init__(self, space, test: bool, compound=None, other=False, op="val",
                 op_args=(), dims=None):
        self.space = space
        self.test = test
        self.compound = compound  # (CompoundFESpace, block index) or None
        self.other = other  # facet .Other()
        self.op = op  # 'val' | 'grad'
        self.op_args = tuple(op_args)
        if dims is not None:
            self.dims = dims
        else:
            vd = getattr(space, "vdim", 1)
            self.dims = () if vd == 1 else (vd,)

    @property
    def has_proxy(self):
        return True

    @property
    def block_key(self):
        """(id) identifying the dof block this proxy contributes to."""
        blk = self.compound[1] if self.compound is not None else 0
        return (blk, self.other)

    def Other(self, bnd=None):
        if bnd is not None:
            # NGSolve's .Other(bnd=g) substitutes boundary data on exterior
            # facets; silently dropping it would assemble a wrong system
            raise NotImplementedError(
                "Other(bnd=...) boundary substitution is not supported; "
                "impose boundary data via a separate BND integral")
        return self._clone(other=True)

    def _clone(self, **kw):
        args = dict(
            space=self.space, test=self.test, compound=self.compound,
            other=self.other, op=self.op, op_args=self.op_args, dims=self.dims,
        )
        args.update(kw)
        return ProxyFunction(**args)

    # -- differential operators ---------------------------------------------
    def grad_op(self):
        if self.op != "val":
            raise TypeError(f"grad of proxy op {self.op}")
        d = self.space.mesh.dim
        vd = getattr(self.space, "vdim", 1)
        dims = (d,) if vd == 1 else (vd, d)
        return self._clone(op="grad", dims=dims)

    def Deriv(self):
        return self.grad_op()

    def Operator(self, name):
        if name == "grad":
            return self.grad_op()
        if name in ("val", "id"):
            return self
        raise NotImplementedError(
            f"Operator({name!r}) on proxies is not ported yet (ROADMAP A9b)")

    def __repr__(self):
        kind = "test" if self.test else "trial"
        return f"Proxy({kind}, op={self.op}, other={self.other})"


def make_proxies(space, test: bool, compound=None):
    return ProxyFunction(space, test=test, compound=compound)


def dn(proxy, order=1, comp=-1, hdiv=False):
    """order-th normal derivative (ghost penalty): not ported yet."""
    raise NotImplementedError(
        "dn (normal-derivative proxies) is not ported yet (ROADMAP A9b)")


def dnjump(proxy, order=1, comp=-1, hdiv=False):
    """Jump of the order-th normal derivative across a facet: not ported
    yet."""
    raise NotImplementedError(
        "dnjump (normal-derivative jumps) is not ported yet (ROADMAP A9b)")


def div(proxy):
    """Divergence of a vector proxy or GridFunction: not ported yet."""
    raise NotImplementedError(
        "div needs vector spaces, which are not ported yet (ROADMAP A9b)")
