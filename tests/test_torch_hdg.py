"""Facet, HDiv and SFE spaces, static condensation and the HDG TraceFEM
example of the port against the JAX package.

The same seeded vectors and forms go through ``ngsxfem_tpu`` (CPU, float64)
and ``ngsxfem_tpu_torch`` (tensors on the CPU): ``FacetFESpace`` dof maps and
``GetDofsOfFacets`` bitwise, facet-space forms to 1e-12 of the largest
entry; ``HDiv`` (RT0) values and ``dn(..., hdiv=True)`` to 1e-12, and the
JAX tests' RT0 constants, divergence theorem and exact normal derivative on
the port; ``SFESpace`` dofs bitwise and its projection to 1e-12;
``condensed_solve`` to 1e-10; ``tracefem_hdg`` L2 errors to 1e-9 relative,
and the limits of ``tests/test_tracefem.py::test_tracefem_hdg_eoc`` on the
port at its sizes.
"""
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu.fem.facetspace import FacetFESpace as JFacetFESpace
from ngsxfem_tpu_torch.fem.facetspace import FacetFESpace

CPU = {"device": "cpu"}


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(a, b, tol=1e-12):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(initial=0.0), 1e-300)
    assert np.abs(a - b).max(initial=0.0) <= tol * scale, \
        np.abs(a - b).max() / scale


def _set(gf, arr):
    gf.vec.data = torch.as_tensor(arr) if isinstance(gf, T.GridFunction) \
        else jnp.asarray(arr)


# -- FacetFESpace -----------------------------------------------------------

@pytest.mark.parametrize("et", ["trig", "quad", "tet"])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_facet_space_maps_and_dofs_of_facets(et, order):
    spaces = []
    for N, FS, dev in ((T, FacetFESpace, CPU), (J, JFacetFESpace, {})):
        mesh = (N.MakeStructured3DMesh(hexes=False, nx=2, ny=2, nz=2)
                if et == "tet" else
                N.MakeStructured2DMesh(quads=et == "quad", nx=3, ny=2))
        spaces.append((N, FS(mesh, order=order, dirichlet=[1, 2], **dev),
                       N.H1(mesh, order=order + 1, **dev),
                       N.L2(mesh, order=order, **dev), mesh))
    (_, ft, ht, lt, mt), (_, fj, hj, lj, mj) = spaces
    assert ft.ndof == fj.ndof
    assert np.array_equal(ft.el2dof_np, fj.el2dof_np)
    assert np.array_equal(ft.FreeDofs().np, fj.FreeDofs().np)
    mask = np.random.default_rng(7).random(mt.nfacets) < 0.5
    for st, sj in ((ft, fj), (ht, hj), (lt, lj)):
        assert np.array_equal(T.GetDofsOfFacets(st, mask).np,
                              J.GetDofsOfFacets(sj, mask).np)


def _facet_forms(N, dev, et):
    """An HDG-type system on a mixed L2 x facet space: element-boundary
    jumps, a facet-indicator weight and an element-boundary load."""
    FS = FacetFESpace if N is T else JFacetFESpace
    mesh = (N.MakeStructured3DMesh(hexes=False, nx=2, ny=2, nz=2)
            if et == "tet" else
            N.MakeStructured2DMesh(quads=et == "quad", nx=3, ny=3))
    V = N.FESpace([N.L2(mesh, order=1, **dev), FS(mesh, order=1, **dev)],
                  dgjumps=True)
    (u, uh), (v, vh) = V.TnT()
    h = N.specialcf.mesh_size
    n = N.specialcf.normal(mesh.dim)
    fmask = np.arange(mesh.nfacets) % 3 != 0
    ind = N.IndicatorCF(mesh, fmask, facets=True)
    a = N.BilinearForm(V)
    a += N.SymbolicBFI(form=N.grad(u) * N.grad(v) + u * v)
    a += N.SymbolicBFI(form=(-(N.grad(u) * n) * (v - vh)
                             - (N.grad(v) * n) * (u - uh)
                             + 10.0 / h * (u - uh) * (v - vh)) * (1 + ind),
                       element_boundary=True)
    a.Assemble()
    f = N.LinearForm(V)
    f += N.SymbolicLFI(form=(1 + N.x) * v)
    f.Assemble()
    return a, f


@pytest.mark.parametrize("et", ["trig", "quad", "tet"])
def test_facet_space_forms(et):
    at, ft = _facet_forms(T, CPU, et)
    aj, fj = _facet_forms(J, {}, et)
    _close(at.mat.todense(), np.asarray(aj.mat.todense()))
    _close(ft.vec.data, np.asarray(fj.vec))


# -- HDiv ---------------------------------------------------------------------

def _rt0_interpolate_constant(mesh, v0):
    """RT0 dofs of a constant field: the outward fluxes over the facets."""
    fverts = mesh.vertices_np[mesh.facets_np]  # (nf, nvf, d)
    if mesh.dim == 2:
        t = fverts[:, 1] - fverts[:, 0]
        n = np.stack([t[:, 1], -t[:, 0]], axis=1)
    else:
        n = 0.5 * np.cross(fverts[:, 1] - fverts[:, 0],
                           fverts[:, 2] - fverts[:, 0])
    e0 = mesh.facet2el_np[:, 0]
    cent_el = mesh.vertices_np[mesh.elements_np[e0]].mean(axis=1)
    s = np.sign(np.einsum("fd,fd->f", n, fverts.mean(axis=1) - cent_el))
    return (n * s[:, None]) @ np.asarray(v0)


def test_rt0_reproduces_constants():
    for N, dev in ((T, CPU), (J, {})):
        errs = []
        for mesh in (N.MakeStructured2DMesh(quads=False, nx=3, ny=3),
                     N.MakeStructured3DMesh(hexes=False, nx=2, ny=2, nz=2)):
            V = N.HDiv(mesh, order=0, **dev)
            assert V.ndof == mesh.nfacets
            v0 = np.arange(1, mesh.dim + 1, dtype=float)
            gf = N.GridFunction(V, **dev)
            _set(gf, _rt0_interpolate_constant(mesh, v0))
            v0cf = N.CoefficientFunction(tuple(float(c) for c in v0))
            errs.append(N.Integrate(cf=N.InnerProduct(gf - v0cf, gf - v0cf),
                                    mesh=mesh, order=3, **dev))
        assert max(abs(e) for e in errs) < 1e-22, errs


def test_rt0_divergence_theorem():
    from ngsxfem_tpu_torch.cf.context import EvalCtx

    mesh = T.MakeStructured2DMesh(quads=False, nx=4, ny=4)
    V = T.HDiv(mesh, order=0, **CPU)
    vec = np.random.default_rng(3).standard_normal(V.ndof)
    flux = vec[mesh.boundary_facets_np].sum()
    cent = torch.full((mesh.ne, 1, mesh.dim), 1.0 / 3.0, dtype=torch.float64)
    ctx = EvalCtx(mesh, cent)
    _, dv = V._piola(ctx, ctx.ref_pts)  # (E,1,nfel)
    div_el = (dv[:, 0] * torch.as_tensor(vec)[V.el2dof_on("cpu")]).sum(1)
    vol = ctx.detJ.abs()[:, 0] * 0.5
    assert abs(float((div_el * vol).sum()) - flux) < 1e-12


def test_dn_hdiv_exact_and_equal():
    """dn(u,1,hdiv=True): RT0 shapes are linear with gradient (c/detJ) I, so
    the normal derivative is (c/detJ) n (signed), dn(u,2) = 0; and the
    factors equal the JAX package's."""
    from ngsxfem_tpu.forms.assemble import (Integral as JIntegral,
                                            _skeleton_ctx as j_skeleton_ctx)
    from ngsxfem_tpu_torch.forms.assemble import Integral, _skeleton_ctx

    mesh = T.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    V = T.HDiv(mesh, order=0, **CPU)
    ctx, e1, _, _, _ = _skeleton_ctx(Integral(form=0.0, skeleton=True), mesh,
                                     2, device=torch.device("cpu"))
    arr = _np(V._dnk(ctx, 1))  # (F,Q,nfel,d)
    n, detJ = _np(ctx.normal), _np(ctx.detJ)
    sign = V.eldof_sign_np[_np(e1)]
    expect = ((1.0 / np.abs(detJ))[:, :, None, None] * n[:, :, None, :]
              * sign[:, None, :, None])
    assert np.abs(arr - expect).max() < 1e-12
    assert _np(V._dnk(ctx, 2)).__abs__().max() < 1e-11
    mj = J.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    Vj = J.HDiv(mj, order=0)
    cj = j_skeleton_ctx(JIntegral(form=J.CoefficientFunction(0.0),
                                  skeleton=True), mj, 2)[0]
    _close(arr, np.asarray(Vj._dnk(cj, 1)))
    # proxies: dn(hdiv=True) on HDiv, TypeError on other spaces
    u = V.TrialFunction()
    assert T.dn(u, 1, hdiv=True).dims == (2,) and T.dn(u, 1).op == "dnk"
    with pytest.raises(TypeError):
        T.dn(T.H1(mesh, order=1, **CPU).TrialFunction(), 1, hdiv=True)


def _hdiv_forms(N, dev):
    """HDiv mass + div-div form with a skeleton dn(hdiv=True) penalty."""
    mesh = N.MakeStructured2DMesh(quads=False, nx=3, ny=3)
    V = N.HDiv(mesh, order=0, **dev)
    u, v = V.TnT()
    a = N.BilinearForm(V)
    a += N.SymbolicBFI(form=u * v + N.div(u) * N.div(v))
    a += N.SymbolicBFI(form=0.1 * N.InnerProduct(
        N.dn(u, 1, hdiv=True) - N.dn(u.Other(), 1, hdiv=True),
        N.dn(v, 1, hdiv=True) - N.dn(v.Other(), 1, hdiv=True)),
        skeleton=True)
    a.Assemble()
    return _np(a.mat.todense())


def test_hdiv_forms():
    _close(_hdiv_forms(T, CPU), _hdiv_forms(J, {}))


# -- SFESpace -----------------------------------------------------------------

def _sfe(N, dev, nx=10):
    mesh = N.MakeStructured2DMesh(
        quads=False, nx=nx, ny=nx,
        mapping=lambda a, b: (3 * a - 1.5, 3 * b - 1.5))
    lsetp1 = N.GridFunction(N.H1(mesh, order=1, **dev))
    N.InterpolateToP1(N.sqrt(N.x * N.x + N.y * N.y) - 1.0, lsetp1)
    return mesh, lsetp1


def test_sfespace_dof_count():
    mesh, lsetp1 = _sfe(T, CPU)
    S = T.SFESpace(mesh, lsetp1, order=1, **CPU)
    ncut = S.CutElements().NumSet()
    assert ncut > 0 and S.ndof == 2 * ncut
    mj, lj = _sfe(J, {})
    Sj = J.SFESpace(mj, lj, order=1)
    assert np.array_equal(S.el2dof_np, Sj.el2dof_np)
    _close(S.cuts_np, np.asarray(Sj.cuts))


def test_sfespace_l2_projection_exact_for_linears():
    out = {}
    for N, dev in ((T, CPU), (J, {})):
        mesh, lsetp1 = _sfe(N, dev)
        S = N.SFESpace(mesh, lsetp1, order=1, **dev)
        u, v = S.TnT()
        lset_if = {"levelset": lsetp1, "domain_type": N.IF}
        a = N.BilinearForm(S)
        a += N.SymbolicBFI(lset_if, form=u * v)
        a.Assemble()
        f = N.LinearForm(S)
        f += N.SymbolicLFI(lset_if, form=(N.x + N.y) * v)
        f.Assemble()
        gfu = N.GridFunction(S, **dev)
        gfu.vec.data = a.mat.Inverse(S.FreeDofs()) * f.vec.data
        err = N.Integrate(lset_if, (gfu - (N.x + N.y)) * (gfu - (N.x + N.y)),
                          mesh, order=4, **dev)
        out[N] = (_np(a.mat.todense()), _np(gfu.vec.data), err)
    assert abs(out[T][2]) < 1e-20, out[T][2]
    _close(out[T][0], out[J][0])
    _close(out[T][1], out[J][1])


# -- static condensation and the HDG example ---------------------------------

def test_condensed_solve_equals_direct():
    """The Schur-complement solve (default CG and a custom solver on the
    explicit complement) equals the direct solve and the JAX package's."""
    from scipy.sparse.linalg import spsolve

    from ngsxfem_tpu.solvers.condense import condensed_solve as j_condense
    from ngsxfem_tpu_torch.solvers.condense import condensed_solve

    at, ft = _facet_forms(T, CPU, "trig")
    aj, fj = _facet_forms(J, {}, "trig")
    nl2 = at.space.components[0].ndof
    local = np.zeros(at.space.ndof, dtype=bool)
    local[:nl2] = True
    x_direct = np.linalg.solve(_np(at.mat.todense()), _np(ft.vec.data))
    x_c = condensed_solve(at.mat, ft.vec.data, local)
    x_s = condensed_solve(at.mat, ft.vec, local,
                          solver=lambda S, r: spsolve(S.tocsc(), r))
    x_j = j_condense(aj.mat, fj.vec.data, local)
    assert x_c.device == torch.device("cpu")
    _close(x_c, x_direct, 1e-10)
    _close(x_s, x_direct, 1e-10)
    _close(x_c, np.asarray(x_j), 1e-10)


@pytest.mark.parametrize("order", [1, 2])
def test_tracefem_hdg_equals_reference(order):
    import sys
    import os

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from examples import tracefem_hdg as jex
    from ngsxfem_tpu_torch.examples import tracefem_hdg as tex

    et = tex.run(8, order=order, verbose=False, **CPU)
    ej = jex.run(8, order=order, verbose=False)
    assert abs(et - ej) <= 1e-9 * ej, (et, ej)


def test_tracefem_hdg_eoc():
    """tests/test_tracefem.py::test_tracefem_hdg_eoc on the port."""
    from ngsxfem_tpu_torch.examples import tracefem_hdg

    e1 = [tracefem_hdg.run(nx, order=1, verbose=False, **CPU)
          for nx in (8, 16)]
    assert math.log(e1[0] / e1[1]) / math.log(2) > 1.75, e1
    e2 = [tracefem_hdg.run(nx, order=2, verbose=False, **CPU)
          for nx in (8, 16)]
    assert math.log(e2[0] / e2[1]) / math.log(2) > 2.6, e2
    assert e2[1] < 3e-4, e2
    ec = tracefem_hdg.run(12, order=1, verbose=False, condense=True, **CPU)
    ed = tracefem_hdg.run(12, order=1, verbose=False, **CPU)
    assert abs(ec - ed) < 1e-8, (ec, ed)
