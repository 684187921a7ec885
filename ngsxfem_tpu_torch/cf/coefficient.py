"""CoefficientFunction graph — the symbolic-coefficient layer.

Counterpart of ``ngsxfem_tpu/cf/coefficient.py``.  Mirrors the user-facing
role of NGSolve ``CoefficientFunction`` (which the reference builds all
integrands from) and evaluates the graph eagerly into batched torch ops at
quadrature-point tensors ``(E, Q, *comps)`` (``cf/context.eval_pure``).
The nodes hold no tensor and no device: an expression is evaluated on the
device of the points it is given.
"""
from __future__ import annotations

import numpy as np
import torch


class CF:
    """Base class: a node in the coefficient expression graph."""

    dims: tuple = ()

    @property
    def dim(self):
        n = 1
        for s in self.dims:
            n *= s
        return n

    # -- operator sugar (NGSolve conventions) --
    def __add__(self, o):
        if _is_zero(o):
            return self
        return Add(self, wrap(o))

    def __radd__(self, o):
        if _is_zero(o):
            return self
        return Add(wrap(o), self)

    def __sub__(self, o):
        return Add(self, Scale(-1.0, wrap(o)))

    def __rsub__(self, o):
        return Add(wrap(o), Scale(-1.0, self))

    def __neg__(self):
        return Scale(-1.0, self)

    def __mul__(self, o):
        return _mul(self, wrap(o))

    def __rmul__(self, o):
        return _mul(wrap(o), self)

    def __truediv__(self, o):
        return Div(self, wrap(o))

    def __rtruediv__(self, o):
        return Div(wrap(o), self)

    def __pow__(self, p):
        return Pow(self, p)

    def __getitem__(self, i):
        return Component(self, i)

    def Norm(self):
        return NormCF(self)

    def Compile(self, *a, **kw):
        return self  # evaluation is eager: nothing to compile

    def Other(self):
        raise TypeError("Other() is only available on proxy functions")

    @property
    def has_proxy(self):
        return any(c.has_proxy for c in self.children())

    def children(self):
        return ()


def _is_zero(o):
    return isinstance(o, (int, float)) and o == 0


def wrap(v):
    if isinstance(v, CF):
        return v
    if isinstance(v, (int, float, np.floating, np.integer)):
        return Constant(float(v))
    if isinstance(v, (tuple, list)):
        return VectorCF([wrap(c) for c in v])
    raise TypeError(f"cannot convert {type(v)} to CoefficientFunction")


def CoefficientFunction(v, dims=None):
    cf = wrap(v)
    if dims is not None:
        cf = Reshaped(cf, tuple(dims))
    return cf


def _mul(a: CF, b: CF) -> CF:
    """NGSolve semantics: scalar*any = scaling; vector*vector = inner product;
    matrix*vector = matvec."""
    if a.dims == () or b.dims == ():
        return Mul(a, b)
    if len(a.dims) == 1 and len(b.dims) == 1:
        return InnerProduct(a, b)
    if len(a.dims) == 2 and len(b.dims) == 1:
        return MatVec(a, b)
    raise TypeError(f"unsupported product dims {a.dims} x {b.dims}")


class Constant(CF):
    def __init__(self, value: float):
        self.value = float(value)


class VectorCF(CF):
    def __init__(self, comps):
        self.comps = [wrap(c) for c in comps]
        # flatten scalar comps only (vector-of-vectors unsupported for now)
        self.dims = (sum(max(c.dim, 1) for c in self.comps),)

    def children(self):
        return self.comps


class Reshaped(CF):
    def __init__(self, child, dims):
        self.child = child
        self.dims = dims

    def children(self):
        return (self.child,)


class Coord(CF):
    """Cartesian coordinate x/y/z, cf. ngsolve.x/y/z."""

    def __init__(self, axis: int):
        self.axis = axis


class Add(CF):
    def __init__(self, a, b):
        if a.dims != b.dims:
            raise TypeError(f"Add: dims mismatch {a.dims} vs {b.dims}")
        self.a, self.b = a, b
        self.dims = a.dims

    def children(self):
        return (self.a, self.b)


class Scale(CF):
    def __init__(self, s: float, a: CF):
        self.s = float(s)
        self.a = a
        self.dims = a.dims

    def children(self):
        return (self.a,)


class Mul(CF):
    """scalar * anything (one side must be scalar)."""

    def __init__(self, a, b):
        self.a, self.b = a, b
        self.dims = b.dims if a.dims == () else a.dims

    def children(self):
        return (self.a, self.b)


class InnerProduct(CF):
    def __init__(self, a, b):
        a, b = wrap(a), wrap(b)
        if a.dims != b.dims:
            raise TypeError(f"InnerProduct dims mismatch {a.dims} vs {b.dims}")
        self.a, self.b = a, b
        self.dims = ()

    def children(self):
        return (self.a, self.b)


class MatVec(CF):
    def __init__(self, a, b):
        self.a, self.b = a, b
        self.dims = (a.dims[0],)

    def children(self):
        return (self.a, self.b)


class Div(CF):
    def __init__(self, a, b):
        if b.dims != ():
            raise TypeError("division by non-scalar")
        self.a, self.b = a, b
        self.dims = a.dims

    def children(self):
        return (self.a, self.b)


class Pow(CF):
    def __init__(self, a, p):
        if a.dims != ():
            raise TypeError("pow of non-scalar")
        self.a = a
        self.p = p  # python number or scalar CF exponent (number only for now)

    def children(self):
        return (self.a,)


class UnaryOp(CF):
    """Elementwise nonlinear function of a scalar (or componentwise) CF."""

    FNS = {
        "sin": torch.sin, "cos": torch.cos, "tan": torch.tan, "exp": torch.exp,
        "log": torch.log, "sqrt": torch.sqrt, "fabs": torch.abs,
        "atan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
        "floor": torch.floor, "ceil": torch.ceil, "erf": torch.special.erf,
    }

    def __init__(self, fname: str, a: CF):
        self.fname = fname
        self.a = a
        self.dims = a.dims

    def children(self):
        return (self.a,)


class Component(CF):
    def __init__(self, a: CF, idx: int):
        if a.dims == ():
            raise TypeError("indexing a scalar CF")
        self.a = a
        self.idx = int(idx)
        self.dims = a.dims[1:]

    def children(self):
        return (self.a,)


class NormCF(CF):
    def __init__(self, a: CF):
        self.a = wrap(a)
        self.dims = ()

    def children(self):
        return (self.a,)


class IfPosCF(CF):
    def __init__(self, c, a, b):
        self.c, self.a, self.b = wrap(c), wrap(a), wrap(b)
        if self.a.dims != self.b.dims:
            raise TypeError("IfPos branches dims mismatch")
        self.dims = self.a.dims

    def children(self):
        return (self.c, self.a, self.b)


class Parameter(CF):
    """Mutable scalar parameter (read at every evaluation)."""

    def __init__(self, value: float):
        self.value = float(value)

    def Set(self, v):
        self.value = float(v)

    def Get(self):
        return self.value


class SpecialCF(CF):
    """mesh_size / normal(dim) — cf. ngsolve.specialcf."""

    def __init__(self, kind: str, dims=()):
        self.kind = kind
        self.dims = dims


class _SpecialCFFactory:
    @property
    def mesh_size(self):
        return SpecialCF("mesh_size")

    def normal(self, dim: int):
        return SpecialCF("normal", (dim,))

    def tangential(self, dim: int):
        return SpecialCF("tangential", (dim,))


specialcf = _SpecialCFFactory()


class ElementValuesCF(CF):
    """Piecewise-constant CF from a per-element value array.

    The batched analog of the reference's ``BitArrayCoefficientFunction``
    (``utils/bitarraycf.hpp:10-21``) and ``CutRatioGF``
    (``python/__init__.py:397``).  ``values`` stay host numpy (or a
    tensor) and go to the device of the evaluation."""

    def __init__(self, values, mesh=None):
        self.values = values if torch.is_tensor(values) else np.asarray(values)
        self.mesh = mesh


class FacetValuesCF(CF):
    """Piecewise-constant CF on facets (evaluated in facet integrals only)."""

    def __init__(self, values, mesh=None):
        self.values = values if torch.is_tensor(values) else np.asarray(values)
        self.mesh = mesh


# -- module-level symbols / functions (ngsolve-like) ------------------------
x = Coord(0)
y = Coord(1)
z = Coord(2)


def sin(a):
    return UnaryOp("sin", wrap(a))


def cos(a):
    return UnaryOp("cos", wrap(a))


def tan(a):
    return UnaryOp("tan", wrap(a))


def exp(a):
    return UnaryOp("exp", wrap(a))


def log(a):
    return UnaryOp("log", wrap(a))


def sqrt(a):
    return UnaryOp("sqrt", wrap(a))


def atan(a):
    return UnaryOp("atan", wrap(a))


def sinh(a):
    return UnaryOp("sinh", wrap(a))


def cosh(a):
    return UnaryOp("cosh", wrap(a))


def fabs(a):
    return UnaryOp("fabs", wrap(a))


def floor(a):
    return UnaryOp("floor", wrap(a))


def ceil(a):
    return UnaryOp("ceil", wrap(a))


def IfPos(c, a, b):
    return IfPosCF(c, a, b)


def Norm(a):
    return NormCF(a)
