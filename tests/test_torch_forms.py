"""Symbolic-form assembly of the PyTorch port against the JAX package.

The same weak forms are written against both packages (``ngsxfem_tpu`` and
``ngsxfem_tpu_torch``, tensors on the CPU, float64): ``a.mat.todense()`` and
``f.vec`` of the cutfem, fictdom_ghostpen (trigs and quads) and fictdom3d
workloads agree to 1e-12 of the largest entry, and so does a seeded form
through every ``eval_form`` branch (Add, Scale, Mul, InnerProduct, MatVec,
Div, Component).  The reference's errors (nonlinear in trial/test, term
without proxy, proxy of another space instance) are raised alike;
``InverseMatrix`` dispatches as ``tests/test_model_review.py:171-186``
holds the reference to; everything not ported raises
``NotImplementedError``, and what was ported since (``subdivlvl``,
``AssembleOperator``, ``dn(hdiv=True)``) gives the JAX package's values.
The three port examples reproduce the reference examples' L2 errors to 1e-9
relative.
"""
import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu_torch.forms import assemble as t_asm
from ngsxfem_tpu_torch.forms import proxies as t_prox

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CPU = {"device": "cpu"}
PKGS = [(J, {}), (T, CPU)]


def _dense(a):
    return np.asarray(a.mat.todense())


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max() / scale


# -- the three workloads, written once against either package ---------------

def _cutfem(N, kw, nx=6):
    from math import pi
    x, y, sqrt, cos, sin, grad = N.x, N.y, N.sqrt, N.cos, N.sin, N.grad
    mesh = N.MakeStructured2DMesh(
        quads=False, nx=nx, ny=nx,
        mapping=lambda xx, yy: (3 * xx - 1.5, 3 * yy - 1.5))
    r44 = x**4 + y**4
    r41 = sqrt(sqrt(r44))
    r4m3 = 1.0 / (r41 * r41 * r41)
    r66 = x**6 + y**6
    r22 = x * x + y * y
    coef_f = [
        -1.0 * sqrt(2.0) * pi * (pi * cos(pi / 4 * r44) * r66
                                 + 3 * sin(pi / 4 * r44) * r22),
        -2.0 * pi * 3 / 2 * r4m3 * (-(r66) / (r44) + r22)]
    alpha = [1.0, 2.0]
    lsetp1 = N.GridFunction(N.H1(mesh, order=1, **kw))
    N.InterpolateToP1(r41 - 1.0, lsetp1)
    Vh = N.H1(mesh, order=1, dirichlet=[1, 2, 3, 4], **kw)
    VhG = N.FESpace([Vh, Vh])
    ci = N.CutInfo(mesh, lsetp1)
    n = 1.0 / grad(lsetp1).Norm() * grad(lsetp1)
    h = N.specialcf.mesh_size
    kappa = (N.CutRatioGF(ci), 1.0 - N.CutRatioGF(ci))
    stab = 20 * (alpha[1] + alpha[0]) / h
    u, v = VhG.TrialFunction(), VhG.TestFunction()
    gradu = [grad(ui) for ui in u]
    gradv = [grad(vi) for vi in v]
    flux_u = sum(-kappa[i] * alpha[i] * (gradu[i] * n) for i in [0, 1])
    flux_v = sum(-kappa[i] * alpha[i] * (gradv[i] * n) for i in [0, 1])
    neg = {"levelset": lsetp1, "domain_type": N.NEG, "subdivlvl": 0}
    pos = {"levelset": lsetp1, "domain_type": N.POS, "subdivlvl": 0}
    iff = {"levelset": lsetp1, "domain_type": N.IF, "subdivlvl": 0}
    a = N.BilinearForm(VhG, symmetric=True)
    a += N.SymbolicBFI(levelset_domain=neg, form=alpha[0] * (gradu[0] * gradv[0]))
    a += N.SymbolicBFI(levelset_domain=pos, form=alpha[1] * (gradu[1] * gradv[1]))
    a += N.SymbolicBFI(levelset_domain=iff,
                       form=flux_u * (v[0] - v[1]) + flux_v * (u[0] - u[1])
                       + stab * (u[0] - u[1]) * (v[0] - v[1]))
    f = N.LinearForm(VhG)
    f += N.SymbolicLFI(levelset_domain=neg, form=coef_f[0] * v[0])
    f += N.SymbolicLFI(levelset_domain=pos, form=coef_f[1] * v[1])
    return a, f


def _ghostpen(N, kw, nx=8, quads=False, order=1, restricted=False):
    x, y, sqrt, grad = N.x, N.y, N.sqrt, N.grad
    mesh = N.MakeStructured2DMesh(
        quads=quads, nx=nx, ny=nx,
        mapping=lambda xx, yy: (2 * xx - 1, 2 * yy - 1))
    r2, r1 = 3 / 4, 1 / 4
    rc, rr = (r1 + r2) / 2.0, (r2 - r1) / 2.0
    r = sqrt(x * x + y * y)
    levelset = N.IfPos(r - rc, r - rc - rr, rc - r - rr)
    coeff_f = N.CoefficientFunction(-20 * ((r1 + r2) / sqrt(x * x + y * y) - 4))
    h = N.specialcf.mesh_size
    lsetp1 = N.GridFunction(N.H1(mesh, order=1, **kw))
    N.InterpolateToP1(levelset, lsetp1)
    # on quads the default OPTIMAL direction ties on this symmetric level
    # set and breaks either way under rounding in both packages: pin it
    pol = {"quad_dir_policy": "FIRST"} if quads else {}
    neg = {"levelset": lsetp1, "domain_type": N.NEG, "subdivlvl": 0, **pol}
    iff = {"levelset": lsetp1, "domain_type": N.IF, "subdivlvl": 0, **pol}
    ci = N.CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(N.HASNEG)
    Vh0 = N.H1(mesh, order=order, dirichlet=[], dgjumps=True, **kw)
    Vh = N.Compress(Vh0, N.GetDofsOfElements(Vh0, hasneg))
    hasif = ci.GetElementsOfType(N.IF)
    ba_facets = N.GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif)
    n_ls = 1.0 / N.Norm(grad(lsetp1)) * grad(lsetp1)
    u, v = Vh.TrialFunction(), Vh.TestFunction()
    nitsche = (-(grad(u) * n_ls) * v - (grad(v) * n_ls) * u
               + (10 * order * order / h) * u * v)
    gp = 0.1 / (h * h) * (u - u.Other()) * (v - v.Other())
    f = N.LinearForm(Vh)
    if restricted:
        a = N.RestrictedBilinearForm(Vh, element_restriction=hasneg,
                                     facet_restriction=ba_facets)
        a += N.SymbolicBFI(neg, form=grad(u) * grad(v))
        a += N.SymbolicBFI(iff, form=nitsche)
        a += N.SymbolicFacetPatchBFI(form=gp)
    else:
        a = N.BilinearForm(Vh, symmetric=False)
        a += N.SymbolicBFI(neg, form=grad(u) * grad(v), definedonelements=hasneg)
        a += N.SymbolicBFI(iff, form=nitsche)
        a += N.SymbolicFacetPatchBFI(form=gp, skeleton=False,
                                     definedonelements=ba_facets)
    f += N.SymbolicLFI(neg, form=coeff_f * v, definedonelements=hasneg)
    return a, f


def _fictdom3d(N, kw, nx=4, hexes=False):
    x, y, z, sqrt, grad = N.x, N.y, N.z, N.sqrt, N.grad
    mesh = N.MakeStructured3DMesh(
        hexes=hexes, nx=nx, ny=nx, nz=nx,
        mapping=lambda a, b, c: (2 * a - 1, 2 * b - 1, 2 * c - 1))
    levelset = sqrt(x * x + y * y + z * z) - 0.7
    h = N.specialcf.mesh_size
    lsetp1 = N.GridFunction(N.H1(mesh, order=1, **kw))
    N.InterpolateToP1(levelset, lsetp1)
    ci = N.CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(N.HASNEG)
    hasif = ci.GetElementsOfType(N.IF)
    Vh = N.H1(mesh, order=1, dgjumps=True, **kw)
    ba_facets = N.GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif)
    n_lset = 1.0 / N.Norm(grad(lsetp1)) * grad(lsetp1)
    u, v = Vh.TnT()
    pol = {"quad_dir_policy": "FIRST"} if hexes else {}   # see _ghostpen
    neg = {"levelset": lsetp1, "domain_type": N.NEG, **pol}
    iff = {"levelset": lsetp1, "domain_type": N.IF, **pol}
    a = N.BilinearForm(Vh)
    a += N.SymbolicBFI(neg, form=grad(u) * grad(v), definedonelements=hasneg)
    a += N.SymbolicBFI(iff, form=-(grad(u) * n_lset) * v
                       - (grad(v) * n_lset) * u + 10 / h * u * v)
    a += N.SymbolicFacetPatchBFI(
        form=0.1 / (h * h) * (u - u.Other()) * (v - v.Other()),
        definedonelements=ba_facets)
    f = N.LinearForm(Vh)
    f += N.SymbolicLFI(neg, form=N.CoefficientFunction(6.0) * v,
                       definedonelements=hasneg)
    return a, f


WORKLOADS = {
    "cutfem-6": (_cutfem, {"nx": 6}),
    "ghostpen-8-trig": (_ghostpen, {"nx": 8}),
    "ghostpen-8-quad": (_ghostpen, {"nx": 8, "quads": True}),
    "ghostpen-6-trig-p2": (_ghostpen, {"nx": 6, "order": 2}),
    "ghostpen-8-restricted": (_ghostpen, {"nx": 8, "restricted": True}),
    "fictdom3d-4": (_fictdom3d, {"nx": 4}),
    "fictdom3d-3-hex": (_fictdom3d, {"nx": 3, "hexes": True}),
}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_assembled_forms_match_reference(name):
    build, args = WORKLOADS[name]
    out = []
    for N, kw in PKGS:
        a, f = build(N, kw, **args)
        a.Assemble()
        f.Assemble()
        out.append((_dense(a), np.asarray(f.vec.data), a))
    (Aj, fj, _), (At, ft, at) = out
    _close(At, Aj)
    _close(ft, fj)
    assert at.mat.vals.dtype == torch.float64 and at.mat.shape == Aj.shape
    # Apply, the product with a dof-vector shim, the transpose
    xv = np.random.default_rng(0).standard_normal(At.shape[1])
    _close(at.Apply(torch.as_tensor(xv)).numpy(), Aj @ xv, 1e-11)
    _close((at.mat.T @ torch.as_tensor(xv)).numpy(), Aj.T @ xv, 1e-11)
    _close(at.mat.CreateTranspose().todense().numpy(), Aj.T)
    _close(at.mat.to_scipy().toarray(), Aj)


def test_restricted_equals_marked():
    """RestrictedBilinearForm == the same form with its integrals marked."""
    a1, _ = _ghostpen(T, CPU, nx=8)
    a2, _ = _ghostpen(T, CPU, nx=8, restricted=True)
    _close(_dense(a2.Assemble()), _dense(a1.Assemble()), 1e-15)


# -- eval_form branches on a seeded form ------------------------------------

def _seeded_form(N, kw, et, order, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.5, 2.0, size=8)
    mk2 = lambda q: N.MakeStructured2DMesh(
        quads=q, nx=3, ny=2, mapping=lambda a, b: (a + 0.2 * b, b + 0.1 * a * a))
    mesh = {"trig": lambda: mk2(False), "quad": lambda: mk2(True),
            "tet": lambda: N.MakeStructured3DMesh(hexes=False, nx=2, ny=1, nz=2)
            }[et]()
    V = N.H1(mesh, order=order, **kw)
    u, v = V.TnT()
    x, y = N.x, N.y
    gu, gv = N.grad(u), N.grad(v)
    d = mesh.dim
    w = N.CoefficientFunction(tuple(c[i] + x * (i + 1) for i in range(d)))
    M = N.CoefficientFunction(
        tuple(c[(i + j) % 8] + (i == j) * 3.0 + 0.1 * y
              for i in range(d) for j in range(d)), dims=(d, d))
    form = (c[0] * gu[0] * gv[d - 1]                       # Component, Scale
            + (gu * gv) / (1.0 + x * x)                    # InnerProduct, Div
            + N.InnerProduct(gu, w) * v * N.sin(x + c[1])  # cfree contraction
            + u * (w * gv)                                 # Mul, coefficient left
            + (M * gu) * gv                                # MatVec
            - c[2] * u * v * w[0]                          # Component of a CF
            + (u + c[3] * u) * (v - 0.5 * v))              # Add inside a product
    a = N.BilinearForm(V)
    a += N.SymbolicBFI(form=form)
    f = N.LinearForm(V)
    f += N.SymbolicLFI(form=(w * gv) + N.cos(y) * v / (2.0 + x)
                       + c[4] * gv[0] + (M * w) * gv)
    return a, f


@pytest.mark.parametrize("et,order", [("trig", 1), ("trig", 2), ("quad", 1),
                                      ("quad", 2), ("tet", 1)])
def test_eval_form_branches_match_reference(et, order):
    out = []
    for N, kw in PKGS:
        a, f = _seeded_form(N, kw, et, order, seed=11)
        out.append((_dense(a.Assemble()), np.asarray(f.Assemble().vec.data)))
    _close(out[1][0], out[0][0])
    _close(out[1][1], out[0][1])


def test_rectangular_form_matches_reference():
    out = []
    for N, kw in PKGS:
        mesh = N.MakeStructured2DMesh(quads=False, nx=3, ny=3)
        Vu, Vv = N.H1(mesh, order=2, **kw), N.H1(mesh, order=1, **kw)
        u, v = Vu.TrialFunction(), Vv.TestFunction()
        a = N.BilinearForm(trialspace=Vu, testspace=Vv)
        a += N.SymbolicBFI(form=u * v + N.grad(u) * N.grad(v))
        out.append(_dense(a.Assemble()))
        assert out[-1].shape == (Vv.ndof, Vu.ndof)
        with pytest.raises(ValueError):
            a.mat.Inverse()
        with pytest.raises(ValueError):
            N.BilinearForm(trialspace=Vu)
        with pytest.raises(ValueError):
            N.BilinearForm(Vu, trialspace=Vu, testspace=Vv)
        with pytest.raises(ValueError):
            N.BilinearForm()
    _close(out[1], out[0])


def test_cf_levelset_and_force_intorder_match_reference():
    """A CoefficientFunction level set is interpolated to P1 by Assemble;
    force_intorder (argument and dict entry) overrides the rule's order."""
    out = []
    for N, kw in PKGS:
        mesh = N.MakeStructured2DMesh(quads=False, nx=5, ny=5)
        V = N.H1(mesh, order=1, **kw)
        u, v = V.TnT()
        ls = N.x + 0.5 * N.y - 0.61
        a = N.BilinearForm(V)
        with pytest.warns(UserWarning):
            a += N.SymbolicBFI({"levelset": ls, "domain_type": N.NEG},
                               form=N.sin(3 * N.x) * u * v, force_intorder=1)
            a += N.SymbolicBFI({"levelset": ls, "domain_type": N.POS,
                                "force_intorder": 5},
                               form=N.sin(3 * N.x) * u * v)
            a.Assemble()
        out.append(_dense(a))
    _close(out[1], out[0])


# -- errors raised alike -----------------------------------------------------

def _err_cases(N, kw):
    mesh = N.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    V, V2 = N.H1(mesh, order=1, **kw), N.H1(mesh, order=1, **kw)
    u, v = V.TnT()
    u2, v2 = V2.TnT()
    g = N.grad

    def bfi(form, space=V):
        a = N.BilinearForm(space)
        a += N.SymbolicBFI(form=form)
        return a.Assemble

    def lfi(form):
        f = N.LinearForm(V)
        f += N.SymbolicLFI(form=form)
        return f.Assemble

    def not_integral():
        a = N.BilinearForm(V)
        a += u * v

    return {
        "nonlinear_trial": bfi(u * u * v),
        "nonlinear_test": bfi(u * v * v),
        "no_proxy_term": bfi(u * v + 1.0),
        "missing_test": bfi(u * N.x),
        "other_space_trial": bfi(u2 * v),
        "other_space_test": bfi(u * v2),
        "nonscalar": bfi(g(u) * v),
        "div_by_proxy": bfi(u / v),
        "other_outside_facet": bfi(u.Other() * v),
        "through_unary": bfi(N.sin(u) * v),
        "lfi_trial": lfi(u * v),
        "lfi_constant": lfi(v + 1.0),
        "lfi_nonscalar": lfi(g(v)),
        "not_an_integral": not_integral,
        "no_integrals": N.BilinearForm(V).Assemble,
        "grad_of_grad": lambda: g(g(u)),
        "other_bnd": lambda: u.Other(bnd=1.0),
    }


@pytest.mark.parametrize("case", list(_err_cases(T, CPU)))
def test_errors_raised_as_the_reference(case):
    with pytest.raises(Exception) as ej:
        _err_cases(J, {})[case]()
    with pytest.raises(type(ej.value)):
        _err_cases(T, CPU)[case]()


# -- InverseMatrix ------------------------------------------------------------

def test_inverse_method_dispatch():
    from scipy.sparse import coo_matrix
    from ngsxfem_tpu_torch.solvers import ell_spmv

    rng = np.random.default_rng(1)
    B = rng.standard_normal((12, 12))
    Ad = B @ B.T + 12 * np.eye(12)
    co = coo_matrix(Ad)
    A = T.SparseMatrix(co.row, co.col, co.data, (12, 12), **CPU)
    b = torch.as_tensor(rng.standard_normal(12))
    x_ref = np.linalg.solve(Ad, b.numpy())
    for name in ("", "sparsecholesky", "umfpack", "pardiso", "masterinverse"):
        x = A.Inverse(inverse=name) * b
        assert x.dtype == torch.float64
        assert np.allclose(x.numpy(), x_ref, atol=1e-8)
    before = ell_spmv.launches
    x_cg = A.Inverse(inverse="cg") * b
    assert np.allclose(x_cg.numpy(), x_ref, atol=1e-6)
    assert ell_spmv.launches == before     # a CPU tensor launches no kernel
    assert isinstance(A.Inverse(), T.InverseMatrix)
    assert np.allclose((T.InverseMatrix(A) @ b).numpy(), x_ref, atol=1e-8)
    with pytest.raises(ValueError):
        A.Inverse(inverse="bogus")
    # free dofs: solve on them, zero elsewhere; direct and cg alike
    free = np.ones(12, bool)
    free[[0, 5]] = False
    xf = np.zeros(12)
    idx = np.nonzero(free)[0]
    xf[idx] = np.linalg.solve(Ad[np.ix_(idx, idx)], b.numpy()[idx])
    assert np.allclose((A.Inverse(T.BitArray(free)) * b).numpy(), xf, atol=1e-8)
    assert np.allclose((A.Inverse(free, inverse="cg") * b).numpy(), xf,
                       atol=1e-6)


def test_inverse_on_assembled_system_matches_reference():
    sols = []
    for N, kw in PKGS:
        a, f = _ghostpen(N, kw, nx=8)
        a.Assemble()
        f.Assemble()
        free = N.GetDofsOfElements(a.space, np.ones(a.space.mesh.ne, bool))
        sols.append([np.asarray(a.mat.Inverse(free, inverse=m) * f.vec.data)
                     for m in ("", "cg")])
        # the solve also takes the vector shim, as the reference's does
        _close(np.asarray(a.mat.Inverse(free) * f.vec), sols[-1][0], 1e-14)
    _close(sols[1][0], sols[0][0], 1e-10)
    _close(sols[1][1], sols[1][0], 1e-8)


# -- what is not ported raises ------------------------------------------------

def test_not_ported_raises():
    mesh = T.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    V = T.H1(mesh, order=1, **CPU)
    u, v = V.TnT()
    lset = T.GridFunction(T.H1(mesh, order=1, **CPU))
    lset.Set(T.x - 0.3)
    ld = {"levelset": lset, "domain_type": T.NEG}
    cases = [
        (lambda: T.SymbolicBFI(form=u * v, skeleton=True,
                               VOL_or_BND=T.BND), "BND cannot"),
        (lambda: T.SymbolicBFI(form=u * v, element_boundary=True,
                               VOL_or_BND=T.BND), "BND cannot"),
        (lambda: T.SymbolicBFI(form=u * v, VOL_or_BND="BBND"), "BBND"),
        (lambda: T.SymbolicFacetPatchBFI(form=u * v, skeleton=True),
         "skeleton"),
        (lambda: u.Operator("hesse"), "Operator"),
    ]
    for fn, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            fn()
    # ported since (ROADMAP A9d): periodic meshes and spaces, and material
    # regions, as the JAX package gives them
    with pytest.raises(ValueError, match="no periodic identification"):
        T.Periodic(V)
    assert mesh.GetMaterials() == ("mat1",)
    assert mesh.Materials("inner").Mask().sum() == 0
    assert mesh.Materials("mat1").Mask().all()
    for args, kw in (((), dict(nx=2, ny=2, periodic="x")),
                     ((), dict(nx=1, ny=1, nz=1, periodic="xy"))):
        make = "MakeStructured2DMesh" if "nz" not in kw else \
            "MakeStructured3DMesh"
        pm_t, pm_j = getattr(T, make)(**kw), getattr(J, make)(**kw)
        assert np.array_equal(pm_t.periodic_facet_np, pm_j.periodic_facet_np)
        assert T.Periodic(T.H1(pm_t, **CPU)).ndof == \
            J.Periodic(J.H1(pm_j)).ndof
    # a proxy op that no factor exists for
    a = T.BilinearForm(V)
    a += T.SymbolicBFI(form=t_prox.ProxyFunction(V, False, op="hesse") * v)
    with pytest.raises(NotImplementedError, match="proxy op hesse"):
        a.Assemble()
    for integral in (T.SymbolicFacetPatchBFI(form=v),
                     T.SymbolicBFI(form=v, skeleton=True),
                     T.SymbolicBFI(form=v, element_boundary=True)):
        f = T.LinearForm(V)
        f += integral
        with pytest.raises(NotImplementedError, match="volume and BND"):
            f.Assemble()
    # ported since (ROADMAP A8b, A10, A13b): a subdivlvl integral, the
    # matrix-free operator and dn(hdiv=True) give the JAX package's values
    mj = J.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    Vj = J.H1(mj, order=1)
    uj, vj = Vj.TnT()
    lj = J.GridFunction(J.H1(mj, order=1))
    lj.Set(J.x - 0.3)
    ldj = {"levelset": lj, "domain_type": J.NEG}
    for N, w, z, l_, sp in ((T, u, v, ld, V), (J, uj, vj, ldj, Vj)):
        b = N.BilinearForm(sp)
        b += N.SymbolicBFI(dict(l_, subdivlvl=1), form=w * z)
        b.Assemble()
        if N is T:
            sub_t, op_t = _dense(b), b.AssembleOperator()
        else:
            _close(sub_t, _dense(b))
            xv = np.linspace(-1.0, 1.0, V.ndof)
            _close(op_t.matvec(torch.as_tensor(xv)).numpy(),
                   np.asarray(b.AssembleOperator().matvec(jnp.asarray(xv))))
    assert T.BilinearForm(V).AssembleOperator().matvec(
        torch.ones(V.ndof, dtype=torch.float64)).abs().max() == 0
    hd_t, hd_j = T.HDiv(mesh, order=0, **CPU), J.HDiv(mj, order=0)
    for N, hd in ((T, hd_t), (J, hd_j)):
        w, z = hd.TnT()
        b = N.BilinearForm(hd)
        b += N.SymbolicBFI(form=N.InnerProduct(N.dn(w, 1, hdiv=True),
                                               N.dn(z, 1, hdiv=True)),
                           skeleton=True)
        b.Assemble()
        if N is T:
            hdiv_t = _dense(b)
        else:
            _close(hdiv_t, _dense(b))
    # what this slice ports builds now: dn, dnjump, div, skeleton,
    # element-boundary and BND integrals
    assert T.dn(u, 1).op == "dnk" and T.dnjump(u, 2).has_proxy
    W = T.VectorH1(mesh, order=1, **CPU)
    assert T.div(W.TrialFunction()).op == "div"
    for kw in ({"skeleton": True}, {"element_boundary": True},
               {"VOL_or_BND": T.BND}):
        b = T.BilinearForm(V)
        b += T.SymbolicBFI(form=u * v, **kw)
        b.Assemble()
        assert b.mat.todense().abs().sum() > 0
    assert u.Operator("grad").op == "grad" and u.Operator("id") is u
    # mesh deformations are ported now (ROADMAP A11): the integrators keep
    # theirs, and the isoparametric branches of the examples run
    deform = T.GridFunction(T.VectorH1(mesh, order=1, **CPU))
    for integral in (T.SymbolicBFI(form=u * v, deformation=deform),
                     T.SymbolicLFI(form=v, deformation=deform),
                     T.SymbolicFacetPatchBFI(form=u * v, deformation=deform)):
        assert integral.deformation is deform
    from ngsxfem_tpu_torch.examples import cutfem
    err = cutfem.run(nx=6, order=2, deform=True, verbose=False, **CPU)
    assert 0 < err < 0.5, err


def _time_order_forms(N, kw):
    """The four integrals that raised before space-time was ported
    (ROADMAP A13): ``time_order`` as an argument and in the level-set dict,
    on a linear form and on a facet-patch integral, over a spatial space
    and a spatial P1 level set (constant in time)."""
    mesh = N.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    V = N.H1(mesh, order=1, **kw)
    u, v = V.TnT()
    lset = N.GridFunction(N.H1(mesh, order=1, **kw))
    lset.Set(N.x - 0.3)
    ld = {"levelset": lset, "domain_type": N.NEG}
    out = []
    for integral in (N.SymbolicBFI(ld, form=u * v, time_order=1),
                     N.SymbolicBFI(dict(ld, time_order=1), form=u * v),
                     N.SymbolicFacetPatchBFI(form=u * v, time_order=0)):
        a = N.BilinearForm(V)
        a += integral
        a.Assemble()
        out.append(np.asarray(a.mat.todense()))
    f = N.LinearForm(V)
    f += N.SymbolicLFI(ld, form=v, time_order=0)
    f.Assemble()
    out.append(np.asarray(f.vec.data))
    return out


def test_time_order_integrals_match_jax():
    """The integrals with ``time_order`` that ``test_not_ported_raises``
    held to ``NotImplementedError`` before space-time was ported now equal
    the JAX package's."""
    for a, b in zip(_time_order_forms(T, CPU), _time_order_forms(J, {})):
        _close(a, b)


def test_integral_options_and_helpers():
    mesh = T.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    V = T.H1(mesh, order=2, **CPU)
    W = T.FESpace([V, T.H1(mesh, order=1, **CPU)])
    u, v = V.TnT()
    g = T.grad
    with pytest.raises(TypeError):
        T.SymbolicBFI({"levelset": None, "domain_type": T.NEG})
    with pytest.raises(TypeError):
        T.SymbolicLFI({"levelset": None, "domain_type": T.NEG})
    i = T.SymbolicBFI(u * v)               # positional form
    assert i.levelset_domain is None and not i.facet_patch
    i.SetDefinedOnElements(T.BitArray(np.ones(mesh.ne, bool)))
    assert i.definedonelements.all()
    assert t_asm._space_order(W) == 2 and t_asm._block_offset(W, 1) == V.ndof
    assert t_asm._block_space(W, 1) is W.components[1]
    assert t_asm._form_difforders(g(u) * g(v)) == (1, 1)
    assert t_asm._form_difforders(g(u) * g(v) + u * v) == (0, 0)
    assert t_asm._form_difforders(T.x * v) == (0, 0)
    assert t_asm._bfi_intorder(T.SymbolicBFI(g(u) * g(v)), mesh, V, V) == 2
    quad = T.MakeStructured2DMesh(quads=True, nx=2, ny=2)
    assert t_asm._bfi_intorder(T.SymbolicBFI(g(u) * g(v)), quad, V, V) == 4
    dm = t_asm.block_dofmap(W, (1, False), torch.tensor([1, 0]), device="cpu")
    assert np.array_equal(dm.numpy(),
                          W.components[1].el2dof_np[[1, 0]] + V.ndof)


# -- the port's examples against the reference's ------------------------------

@pytest.mark.parametrize("name,args", [("cutfem", {"nx": 8}),
                                       ("fictdom_ghostpen", {"nx": 10}),
                                       ("fictdom3d", {"nx": 4})])
def test_examples_match_reference(name, args):
    import importlib

    ref = importlib.import_module(f"examples.{name}")
    port = importlib.import_module(f"ngsxfem_tpu_torch.examples.{name}")
    ej = ref.run(verbose=False, **args)
    et = port.run(verbose=False, **args, **CPU)
    assert abs(et - ej) <= 1e-9 * abs(ej), (et, ej)
