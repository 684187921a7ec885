"""Trial/test proxy functions and their differential operators.

Counterpart of ``ngsxfem_tpu/forms/proxies.py`` (the replacement for
NGSolve's symbolic proxy framework that the reference's cut integrators plug
into, ``xfem/symboliccutbfi.cpp:151-215``): a proxy evaluates to a *basis
factor tensor* ``(E, Q, ndof_el, *comps)``; form evaluation propagates
bilinear jets (forms/evaluate.py).  Ported: value and gradient proxies,
``.Other()``, ``div``, the exact normal derivatives ``dn``/``dnjump``
(with ``hdiv=True`` on ``HDiv`` spaces), ``Operator`` for the names the
reference accepts (others through a space's ``proxy_operator_hook``, as in
the JAX package), and the space-time operators ``dt``/``fix_t``
(``spacetime/space.py``, evaluated by
``SpaceTimeFESpace.proxy_factor_hook``).
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
        self.op = op  # 'val' | 'grad' | 'div' | 'dnk' | xfem ops...
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
        # dispatch known operators through their dims-setting constructors;
        # a bare clone would carry stale scalar dims into proxy_factor
        if name == "grad":
            return self.grad_op()
        if name == "div":
            return div(self)
        if name in ("val", "id"):
            return self
        hook = getattr(self.space, "proxy_operator_hook", None)
        if hook is not None:
            return hook(self, name)
        raise NotImplementedError(f"Operator({name!r}) on this space")

    def __repr__(self):
        kind = "test" if self.test else "trial"
        return f"Proxy({kind}, op={self.op}, other={self.other})"


def make_proxies(space, test: bool, compound=None):
    return ProxyFunction(space, test=test, compound=compound)


def dn(proxy, order=1, comp=-1, hdiv=False):
    """order-th normal derivative (ghost penalty), cf.
    xfem/ghostpenalty.hpp:10-41.

    Evaluated exactly for polynomial bases by a 1D restriction along the
    facet normal (forms/evaluate.py ``_dnk_factor``), where the reference
    uses central finite differences (xfem/ghostpenalty.cpp:8-130).  On a
    vector space it is componentwise, ``(vdim,)``-valued.  With
    ``hdiv=True`` (or an HDiv-space proxy) it is the vector-valued normal
    derivative of the Piola-mapped shapes (DiffOpDuDnkHDiv,
    ghostpenalty.cpp:140-199)."""
    if not isinstance(proxy, ProxyFunction):
        raise TypeError("dn expects a proxy function")
    if proxy.op != "val":
        raise TypeError("dn expects a value proxy")
    from ..fem.hdiv import HDiv

    if hdiv or isinstance(proxy.space, HDiv):
        if not isinstance(proxy.space, HDiv):
            raise TypeError("dn(hdiv=True) expects an HDiv-space proxy")
        return proxy._clone(op="dnk", op_args=(int(order),),
                            dims=(proxy.space.mesh.dim,))
    vd = getattr(proxy.space, "vdim", 1)
    return proxy._clone(op="dnk", op_args=(int(order),),
                        dims=() if vd == 1 else (vd,))


def dnjump(proxy, order=1, comp=-1, hdiv=False):
    """Jump of the order-th normal derivative across a facet.

    ``dn`` is evaluated along each element's *outward* facet normal, which
    flips between the two neighbours, so even orders subtract and odd
    orders add to form the true jump ``[[d^k u / dn^k]]`` (the reference's
    ``dnjump`` helper, python/__init__.py)."""
    k = int(order)
    a = dn(proxy, k, comp=comp, hdiv=hdiv)
    b = dn(proxy.Other(), k, comp=comp, hdiv=hdiv)
    return a - b if k % 2 == 0 else a + b


def div(proxy):
    """Divergence of a vector proxy, or of a vector GridFunction (the trace
    of its gradient)."""
    if isinstance(proxy, ProxyFunction):
        return proxy._clone(op="div", dims=())
    from ..fem.gridfunction import GridFunction, grad

    if isinstance(proxy, GridFunction) and proxy.dims:
        # the reference indexes g[i, i], which its Component node rejects
        # (int() of a tuple); g[i][i] is the same entry
        g = grad(proxy)
        out = g[0][0]
        for i in range(1, proxy.dims[0]):
            out = out + g[i][i]
        return out
    raise TypeError("div expects a proxy function or vector GridFunction")
