"""Skeleton, element-boundary and boundary integrals of the PyTorch port
against the JAX package.

The same forms are written against both packages (tensors on the CPU,
float64) on trig, quad, tet and hex meshes at nx <= 3: skeleton
(``skeleton=True``), element-boundary (``element_boundary=True``) and
boundary (``VOL_or_BND=BND``) integrals, plain and under a level-set
domain (the cut rule on the facet itself, NEG and the codim-2 IF branch),
with facet normals, ``.Other()``, mesh size and ``dn``/``dnjump``;
``a.mat.todense()`` and ``f.vec`` agree to 1e-12 of the largest entry.  The
exact cases of ``tests/test_bnd.py`` (perimeter, 3D area, the cut boundary
measure, the Neumann ``LinearForm``), ``tests/test_workloads.py::
test_cut_facet_rule_exact`` and the ``dn``/``dnjump`` cases of
``tests/test_ghostpenalty.py:27-91`` run on the port.
"""
import numpy as np
import pytest
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu_torch.forms.assemble import Integral, _skeleton_ctx
from ngsxfem_tpu_torch.forms.evaluate import _dnk_factor
from ngsxfem_tpu_torch.cf.context import eval_pure
from ngsxfem_tpu_torch.cf.coefficient import wrap

CPU = {"device": "cpu"}
PKGS = ((J, {}), (T, CPU))


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max() / scale


def _mesh(N, et):
    if et in ("trig", "quad"):
        return N.MakeStructured2DMesh(quads=et == "quad", nx=3, ny=3,
                                      mapping=lambda a, b: (2 * a, b + 0.5))
    return N.MakeStructured3DMesh(hexes=et == "hex", nx=2, ny=2, nz=2)


def _facet_forms(N, kw, et, dt):
    mesh = _mesh(N, et)
    d = mesh.dim
    x, y, z = N.x, N.y, N.z
    lset = N.GridFunction(N.H1(mesh, order=1, **kw))
    N.InterpolateToP1(x + 0.7 * y + (0.4 * z if d == 3 else 0.0) - 0.93,
                      lset)
    ld = (None if dt is None
          else {"levelset": lset, "domain_type": getattr(N, dt)})
    V = N.L2(mesh, order=2 if d == 2 else 1, dgjumps=True, **kw)
    u, v = V.TnT()
    n, h, g = N.specialcf.normal(d), N.specialcf.mesh_size, N.grad
    skel = ((u - u.Other()) * (v - v.Other()) / h
            + 0.5 * ((g(u) + g(u.Other())) * n) * (v - v.Other())
            + (x + 1.0) * u * v.Other())
    one_sided = (1.0 + y) * u * v + (g(u) * n) * v - u * (g(v) * n)
    a = N.BilinearForm(V)
    args = () if ld is None else (ld,)
    a += N.SymbolicBFI(*args, form=skel, skeleton=True)
    a += N.SymbolicBFI(*args, form=one_sided, element_boundary=True)
    a += N.SymbolicBFI(*args, form=h * one_sided, VOL_or_BND=N.BND)
    a.Assemble()
    f = N.LinearForm(V)
    f += N.SymbolicLFI(*args, form=(x + n[0]) * v, VOL_or_BND=N.BND)
    f += N.SymbolicLFI(form=y * v)
    f.Assemble()
    return np.asarray(a.mat.todense()), np.asarray(f.vec.data)


@pytest.mark.parametrize("dt", [None, "NEG", "IF"])
@pytest.mark.parametrize("et", ["trig", "quad", "tet", "hex"])
def test_facet_integrals_match_jax(et, dt):
    (Aj, fj), (At, ft) = (_facet_forms(N, kw, et, dt) for N, kw in PKGS)
    assert np.abs(Aj).max() > 0
    _close(At, Aj)
    _close(ft, fj)


@pytest.mark.parametrize("how", ["boundary facets", "volume elements"])
def test_restricted_facet_and_bnd_selections(how):
    """facet_restriction of a RestrictedBilinearForm on skeleton integrals,
    element restriction of element-boundary integrals and a BND mark given
    over boundary facets or volume elements, as the reference reads them."""
    out = []
    for N, kw in PKGS:
        mesh = N.MakeStructured2DMesh(quads=False, nx=4, ny=4)
        rng = np.random.default_rng(11)
        fmask = N.BitArray(rng.random(mesh.nfacets) < 0.5)
        emask = N.BitArray(rng.random(mesh.ne) < 0.5)
        nb = len(mesh.boundary_facets_np)
        bmask = N.BitArray(rng.random(nb if how == "boundary facets"
                                      else mesh.ne) < 0.5)
        V = N.L2(mesh, order=1, dgjumps=True, **kw)
        u, v = V.TnT()
        a = N.RestrictedBilinearForm(V, element_restriction=emask,
                                     facet_restriction=fmask)
        a += N.SymbolicBFI(form=(u - u.Other()) * (v - v.Other()),
                           skeleton=True)
        a += N.SymbolicBFI(form=u * v, element_boundary=True)
        a += N.SymbolicBFI(form=u * v, VOL_or_BND=N.BND,
                           definedonelements=bmask)
        a.Assemble()
        out.append(np.asarray(a.mat.todense()))
    _close(out[1], out[0])


def test_bnd_exact_cases():
    """tests/test_bnd.py's exact values and the cut facet rule of
    tests/test_workloads.py::test_cut_facet_rule_exact, on the port."""
    one = lambda V: torch.ones(V.ndof, dtype=torch.float64)

    def total(a, V):
        return float(one(V) @ a.mat.todense() @ one(V))

    mesh = T.MakeStructured2DMesh(quads=False, nx=4, ny=4)
    V = T.H1(mesh, order=2, **CPU)
    u, v = V.TnT()
    a = T.BilinearForm(V)
    a += T.SymbolicBFI(form=u * v, VOL_or_BND=T.BND)
    a.Assemble()
    assert abs(total(a, V) - 4.0) < 1e-12

    mesh3 = T.MakeStructured3DMesh(hexes=False, nx=3, ny=3, nz=3)
    V3 = T.H1(mesh3, order=1, **CPU)
    u3, v3 = V3.TnT()
    a3 = T.BilinearForm(V3)
    a3 += T.SymbolicBFI(form=u3 * v3, VOL_or_BND=T.BND)
    a3.Assemble()
    assert abs(total(a3, V3) - 6.0) < 1e-12

    mesh5 = T.MakeStructured2DMesh(quads=False, nx=5, ny=5)
    V5 = T.H1(mesh5, order=1, **CPU)
    u5, v5 = V5.TnT()
    lset = T.GridFunction(T.H1(mesh5, order=1, **CPU))
    T.InterpolateToP1(T.x - 0.45, lset)
    for dt, want in ((T.NEG, 1.0 + 2 * 0.45), (T.POS, 1.0 + 2 * 0.55)):
        b = T.BilinearForm(V5)
        b += T.SymbolicBFI(levelset_domain={"levelset": lset,
                                            "domain_type": dt},
                           form=u5 * v5, VOL_or_BND=T.BND)
        b.Assemble()
        assert abs(total(b, V5) - want) < 1e-12

    # Neumann data through a BND LinearForm: u - lap u = x, du/dn = n_x
    Vn = T.H1(mesh, order=1, **CPU)
    un, vn = Vn.TnT()
    an = T.BilinearForm(Vn)
    an += T.SymbolicBFI(form=T.grad(un) * T.grad(vn))
    an += T.SymbolicBFI(form=un * vn)
    an.Assemble()
    fn = T.LinearForm(Vn)
    fn += T.SymbolicLFI(form=T.x * vn)
    fn += T.SymbolicLFI(form=T.specialcf.normal(2)[0] * vn, VOL_or_BND=T.BND)
    fn.Assemble()
    gfu = T.GridFunction(Vn)
    gfu.vec.data = an.mat.Inverse() * fn.vec.data
    err = T.Integrate(cf=(gfu - T.x) * (gfu - T.x), mesh=mesh, order=4,
                      **CPU) ** 0.5
    assert err < 1e-10

    # the NEG part of the cut diagonal of one square
    m1 = T.MakeStructured2DMesh(quads=False, nx=1, ny=1)
    l1 = T.GridFunction(T.H1(m1, order=1, **CPU))
    T.InterpolateToP1(1 - 2 * T.x, l1)
    Vh = T.H1(m1, order=1, dgjumps=True, **CPU)
    uh, vh = Vh.TnT()
    ah = T.BilinearForm(Vh)
    ah += T.SymbolicBFI({"levelset": l1, "domain_type": T.NEG}, form=uh * vh,
                        skeleton=True)
    ah.Assemble()
    assert abs(float(ah.mat.todense().sum()) - 2**0.5 / 2) < 1e-13


def test_dn_exactness():
    """dn(u, k) is exact for polynomials up to the space order (the
    Chebyshev-Vandermonde directional derivative), as
    tests/test_ghostpenalty.py::test_dn_exactness holds the reference."""
    mesh = T.MakeStructured2DMesh(quads=False, nx=3, ny=3)
    order = 3
    V = T.H1(mesh, order=order, **CPU)
    gf = T.GridFunction(V)
    gf.Set(T.x**3 + T.x * T.y * T.y)
    ctx, e1, e2, w, mask = _skeleton_ctx(Integral(form=wrap(0.0),
                                                  skeleton=True),
                                         mesh, 2 * order, device="cpu")
    n = ctx.normal
    xs = torch.broadcast_to(eval_pure(wrap(T.x), ctx), w.shape)
    ys = torch.broadcast_to(eval_pure(wrap(T.y), ctx), w.shape)
    dofs = gf.vec.data[V.el2dof_on("cpu")[e1]]
    for k, exact in [
        (1, (3 * xs**2 + ys**2) * n[..., 0] + 2 * xs * ys * n[..., 1]),
        (2, 6 * xs * n[..., 0] ** 2 + 2 * ys * 2 * n[..., 0] * n[..., 1]
            + 2 * xs * n[..., 1] ** 2),
        (3, 6 * n[..., 0] ** 3 + 6 * n[..., 0] * n[..., 1] ** 2),
    ]:
        arr = _dnk_factor(mesh.et, order, k, ctx)  # (F, Q, ndl)
        num = (arr * dofs[:, None, :]).sum(-1)
        err = float((num - exact).abs().max())
        assert err < 5e-11 * (10 ** k), (k, err)


def test_library_dnjump_matches_manual():
    """dnjump equals the hand-built sign-parity expression
    dn(u,k) -/+ dn(u.Other(),k): the assembled ELL tables are identical
    (tests/test_ghostpenalty.py::test_library_dnjump_matches_manual)."""
    mesh = T.MakeStructured2DMesh(quads=False, nx=5, ny=5)
    V = T.H1(mesh, order=2, dgjumps=True, **CPU)
    u, v = V.TnT()
    h = T.specialcf.mesh_size
    for k in (1, 2):
        manual_u = (T.dn(u, k) - T.dn(u.Other(), k) if k % 2 == 0
                    else T.dn(u, k) + T.dn(u.Other(), k))
        manual_v = (T.dn(v, k) - T.dn(v.Other(), k) if k % 2 == 0
                    else T.dn(v, k) + T.dn(v.Other(), k))
        a1 = T.BilinearForm(V)
        a1 += T.SymbolicBFI(form=h ** (2 * k + 1) * manual_u * manual_v,
                            skeleton=True)
        a1.Assemble()
        a2 = T.BilinearForm(V)
        a2 += T.SymbolicBFI(form=h ** (2 * k + 1) * T.dnjump(u, k)
                            * T.dnjump(v, k), skeleton=True)
        a2.Assemble()
        assert torch.equal(a1.mat.ell().vals, a2.mat.ell().vals), k


@pytest.mark.parametrize("et,order", [("trig", 2), ("quad", 2), ("tet", 2)])
def test_dnjump_ghost_penalty_matches_jax(et, order):
    """The dn-jump ghost penalty of examples/fictdom_dn_ghostpen.py on the
    selected facets, every derivative order up to the space order."""
    out = []
    for N, kw in PKGS:
        mesh = _mesh(N, et)
        V = N.H1(mesh, order=order, dgjumps=True, **kw)
        u, v = V.TnT()
        h = N.specialcf.mesh_size
        sel = N.BitArray(np.random.default_rng(3).random(mesh.nfacets) < 0.6)
        gp = 0
        for i in range(order):
            gp = gp + 0.1 ** (i + 1) * h ** (2 * i + 1) \
                * N.dnjump(u, i + 1) * N.dnjump(v, i + 1)
        a = N.BilinearForm(V)
        a += N.SymbolicBFI(form=gp, skeleton=True, definedonelements=sel)
        a.Assemble()
        out.append(np.asarray(a.mat.todense()))
    _close(out[1], out[0])
