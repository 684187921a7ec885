"""XFESpace (Heaviside enrichment) of the PyTorch port against the JAX
package: the cases of ``tests/test_xfespace.py`` but the static
condensation (ROADMAP A12b), and the two XFEM examples.

Dof maps are held bitwise (ndof, base/x-dof maps, element maps and their
valid slots, dof domains, Dirichlet marks where the cut touches the
boundary, the ``trace=True`` LOCAL marks, ``FreeDofs``), GridFunction
operators (``neg``/``pos``/``extend`` and their gradients, ``XToNegPos``)
to 1e-14, the Nitsche-XFEM matrix and load to 1e-12 of the largest entry,
and ``examples.nxfem`` / ``examples.xfespaces`` to 1e-9 of the JAX
examples (nx=15 as ``tests/test_workloads.py`` runs it).
"""
import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu.cf.context import EvalCtx as JCtx, eval_pure as j_eval
from ngsxfem_tpu_torch.cf.context import EvalCtx as TCtx, eval_pure as t_eval

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CPU = {"device": "cpu"}
PKGS = ((J, {}), (T, CPU))
XMAPS = ("basedof2xdof", "xdof2basedof", "el2dof_np", "el2dof_valid_np",
         "dom_of_basedof", "dom_of_xdof", "dirichlet_dofs", "local_dofs")


def _xspaces(N, kw, mesh_fn, lset_fn, order, dirichlet=None, trace=False,
             via_cutinfo=False):
    mesh = mesh_fn(N)
    lsetp1 = N.GridFunction(N.H1(mesh, order=1, **kw))
    N.InterpolateToP1(lset_fn(N), lsetp1)
    base = N.H1(mesh, order=order, dirichlet=dirichlet, **kw)
    arg = N.CutInfo(mesh, lsetp1) if via_cutinfo else lsetp1
    return mesh, lsetp1, base, N.XFESpace(base, arg, trace=trace)


def _same_maps(xt, xj):
    assert xt.ndof == xj.ndof and xt.ndof > 0
    for attr in XMAPS:
        a, b = np.asarray(getattr(xt, attr)), np.asarray(getattr(xj, attr))
        assert a.dtype == b.dtype and np.array_equal(a, b), attr
    for coupling in (False, True):
        assert np.array_equal(xt.FreeDofs(coupling).np,
                              xj.FreeDofs(coupling).np)


_unit2 = lambda N: N.MakeStructured2DMesh(quads=False, nx=8, ny=8)
_circle = lambda N: N.sqrt((N.x - 0.5) ** 2 + (N.y - 0.5) ** 2) - 0.3


@pytest.mark.parametrize("order", [1, 2])
def test_xfes_ndof_and_maps(order):
    (_, _, bj, xj), (_, _, bt, xt) = (
        _xspaces(N, kw, _unit2, _circle, order) for N, kw in PKGS)
    _same_maps(xt, xj)
    cutels = xt.GetCutInfo().GetElementsOfType(T.IF).np
    manual = np.zeros(bt.ndof, dtype=bool)
    manual[bt.el2dof_np[cutels].ravel()] = True
    assert xt.ndof == manual.sum()
    assert set(np.unique(xt.dom_of_xdof)) <= {0, 1}
    el = int(np.nonzero(cutels)[0][0])
    assert xt.GetDomainNrs(el) == xj.GetDomainNrs(el)
    assert xt.GetDomainNrs(int(np.nonzero(~cutels)[0][0])) == []
    for i in (0, xt.ndof - 1):
        assert xt.BaseDofOfXDof(i) == xj.BaseDofOfXDof(i)
        assert xt.GetDomainOfDof(i) == xj.GetDomainOfDof(i)


def test_xfes_dirichlet_where_cut_touches_boundary():
    """xFESpace.cpp:368-399: an enrichment dof is Dirichlet iff its base dof
    is and it supports a boundary element crossed by the interface."""
    mesh6 = lambda N: N.MakeStructured2DMesh(quads=False, nx=6, ny=6)
    for lset, crosses in ((lambda N: N.y - 0.52, True),
                          (lambda N: (N.x - 0.5) ** 2 + (N.y - 0.5) ** 2
                           - 0.09, False)):
        (_, _, _, xj), (_, _, _, xt) = (
            _xspaces(N, kw, mesh6, lset, 1, dirichlet=[1, 2, 3, 4],
                     via_cutinfo=True) for N, kw in PKGS)
        _same_maps(xt, xj)
        assert (xt.dirichlet_dofs.sum() > 0) == crosses
        assert (~xt.FreeDofs().np == xt.dirichlet_dofs).all()


def test_xfespace_trace_local_dofs():
    """trace=True marks the outer-rim face bubbles LOCAL (xFESpace.cpp:72-97)
    as the reference does; FreeDofs(coupling=True) leaves them out."""
    mesh3 = lambda N: N.MakeStructured3DMesh(hexes=False, nx=3, ny=3, nz=3)
    sphere = lambda N: N.sqrt((N.x - 0.5) ** 2 + (N.y - 0.5) ** 2
                              + (N.z - 0.5) ** 2) - 0.3
    (_, _, _, xj), (_, _, _, xt) = (
        _xspaces(N, kw, mesh3, sphere, 3, trace=True, via_cutinfo=True)
        for N, kw in PKGS)
    _same_maps(xt, xj)
    loc = xt.LocalDofs().np
    assert loc.any() and not loc.all()
    assert xt.FreeDofs(coupling=True).np.sum() == (~loc).sum()


def test_xgridfunction_operators():
    """neg/pos/extend and their gradients of an XFESpace GridFunction at
    seeded points of every element, and XToNegPos, to 1e-14."""
    vals = np.random.default_rng(5)
    out = []
    for N, kw in PKGS:
        mesh, lsetp1, base, X = _xspaces(N, kw, _unit2, _circle, 2)
        gfx = N.GridFunction(X)
        if not out:
            x = vals.standard_normal(X.ndof)
        gfx.vec.data = x if N is T else jnp.asarray(x)
        pts = np.random.default_rng(6).random((mesh.ne, 3, 2))
        pts = pts / (1.0 + pts.sum(-1, keepdims=True))
        if N is J:
            ctx, ev = JCtx(mesh, jnp.asarray(pts)), j_eval
        else:
            ctx, ev = TCtx(mesh, torch.as_tensor(pts)), t_eval
        res = [np.asarray(ev(op(gfx), ctx))
               for op in (N.neg, N.pos, N.extend, N.neg_grad, N.pos_grad,
                          N.extend_grad)]
        res.append(np.asarray(ev(gfx, ctx)))
        two = N.GridFunction(N.FESpace([base, base]))
        N.XToNegPos(gfx, two)
        res += [np.asarray(c.vec.data) for c in two.components]
        out.append(res)
    for a, b in zip(out[1], out[0]):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-14 * max(1.0, np.abs(b).max())


def test_nxfem_forms_match():
    """The Nitsche-XFEM forms of examples/nxfem.py at nx=6: a.mat and f.vec
    to 1e-12 of the largest entry, the free dofs bitwise."""
    from ngsxfem_tpu_torch.examples import nxfem

    a, f, VhG, free, _, gfu = nxfem.system(nx=6, device="cpu")
    a.Assemble()
    f.Assemble()
    # the same forms through the JAX package, with its dof numbering
    import examples.cutfem as jcutfem

    mesh = J.MakeStructured2DMesh(quads=False, nx=6, ny=6,
                                  mapping=lambda a_, b_: (3 * a_ - 1.5,
                                                          3 * b_ - 1.5))
    solution, coef_f, alpha, levelset = jcutfem.manufactured_interface_problem()
    lsetp1 = J.GridFunction(J.H1(mesh, order=1))
    J.InterpolateToP1(levelset, lsetp1)
    Vh = J.H1(mesh, order=1, dirichlet=[1, 2, 3, 4])
    Vhx = J.XFESpace(Vh, lsetp1)
    G = J.FESpace([Vh, Vhx])
    n = 1.0 / J.grad(lsetp1).Norm() * J.grad(lsetp1)
    h = J.specialcf.mesh_size
    kappa = [J.CutRatioGF(Vhx.GetCutInfo()), 1.0 - J.CutRatioGF(Vhx.GetCutInfo())]
    stab = 10 * (alpha[1] + alpha[0]) * 2 / h
    us, ux = G.TrialFunction()
    vs, vx = G.TestFunction()
    u = [us + op(ux) for op in [J.neg, J.pos]]
    v = [vs + op(vx) for op in [J.neg, J.pos]]
    gu = [J.grad(us) + op(ux) for op in [J.neg_grad, J.pos_grad]]
    gv = [J.grad(vs) + op(vx) for op in [J.neg_grad, J.pos_grad]]
    fu = sum(-kappa[i] * alpha[i] * (gu[i] * n) for i in [0, 1])
    fv = sum(-kappa[i] * alpha[i] * (gv[i] * n) for i in [0, 1])
    lds = [{"levelset": lsetp1, "domain_type": dt} for dt in (J.NEG, J.POS, J.IF)]
    aj = J.BilinearForm(G, symmetric=True)
    aj += J.SymbolicBFI(levelset_domain=lds[0], form=alpha[0] * (gu[0] * gv[0]))
    aj += J.SymbolicBFI(levelset_domain=lds[1], form=alpha[1] * (gu[1] * gv[1]))
    aj += J.SymbolicBFI(levelset_domain=lds[2], form=fu * (v[0] - v[1]))
    aj += J.SymbolicBFI(levelset_domain=lds[2], form=fv * (u[0] - u[1]))
    aj += J.SymbolicBFI(levelset_domain=lds[2],
                        form=stab * (u[0] - u[1]) * (v[0] - v[1]))
    aj.Assemble()
    fj = J.LinearForm(G)
    fj += J.SymbolicLFI(levelset_domain=lds[0], form=coef_f[0] * v[0])
    fj += J.SymbolicLFI(levelset_domain=lds[1], form=coef_f[1] * v[1])
    fj.Assemble()
    Aj, At = np.asarray(aj.mat.todense()), a.mat.todense().numpy()
    assert np.abs(At - Aj).max() <= 1e-12 * np.abs(Aj).max()
    fjn, ftn = np.asarray(fj.vec.data), f.vec.NumPy()
    assert np.abs(ftn - fjn).max() <= 1e-12 * np.abs(fjn).max()
    assert np.array_equal(free.np, G.FreeDofs().np)


def test_xfem_examples_match_jax():
    """examples.nxfem at nx=15 and examples.xfespaces against the JAX
    examples (1e-9), and the XFEM and CutFEM formulations of the interface
    problem equal to 1e-9 (tests/test_xfespace.py::test_xfem_equals_cutfem)."""
    from examples import nxfem as jnxfem, xfespaces as jxfespaces
    from ngsxfem_tpu_torch.examples import cutfem, nxfem, xfespaces

    ej = jnxfem.run(nx=15, verbose=False)
    et = nxfem.run(nx=15, verbose=False, device="cpu")
    assert abs(et - ej) <= 1e-9 * ej and et < 0.08
    assert xfespaces.run(verbose=False, device="cpu") == \
        jxfespaces.run(verbose=False)
    nums = xfespaces.system(device="cpu")
    assert abs(nums["int_NEG neg(u_x)"] + nums["int_POS pos(u_x)"]) > 0
    e1 = cutfem.run(nx=10, order=1, verbose=False, device="cpu")
    e2 = nxfem.run(nx=10, order=1, verbose=False, device="cpu")
    assert abs(e1 - e2) < 1e-9, (e1, e2)
    # the deform=True branch runs since the mesh adaptation is ported
    # (ROADMAP A11); its L2 error falls with the order
    e_def = nxfem.run(nx=6, order=2, deform=True, verbose=False,
                      device="cpu")
    assert 0 < e_def < nxfem.run(nx=6, order=1, verbose=False,
                                 device="cpu"), e_def
