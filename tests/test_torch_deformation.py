"""Mesh deformations in ``Integrate`` and in the forms of the PyTorch port,
against the JAX package.

An isoparametric deformation (``LevelSetMeshAdaptation``, order 2 or 3,
tensors on the CPU, float64) is applied through ``mesh.SetDeformation``,
through ``Integrate(..., deformation=)`` and through an integral's own
``deformation=``; the same integrals go through both packages:
``Integrate`` over NEG, POS and IF (1e-12 relative; the mesh holds no
deformation after a call with ``deformation=``), and the assembled
matrices and vectors of every context builder (volume, cut volume, IF,
facet patch with its Newton map, skeleton, element boundary and BND) to
1e-12 of the largest entry, on trig meshes (nx=6), on tet meshes (nx=3;
the volume builders there through the examples) and the facet patch on
quads.  The isoparametric examples run against the
JAX examples (L2 errors within 1e-8 relative) and with the limits of
``tests/test_workloads.py`` (the restricted form, ``nxfem_higher_order``,
``fictdom3d(isoparametric=True)``).
"""
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CPU = {"device": "cpu"}
PKGS = ((J, {}), (T, CPU))


def _dense(mat):
    d = mat.todense()
    return d.cpu().numpy() if torch.is_tensor(d) else np.asarray(d)


def _vec(v):
    return v.NumPy() if hasattr(v, "NumPy") else np.asarray(v.data)


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max() / scale


def _setup(N, kw, et, order=2):
    """(mesh, lsa, deformation) on a small mesh of ``et``."""
    if et in ("trig", "quad"):
        mesh = N.MakeStructured2DMesh(
            quads=et == "quad", nx=6, ny=6,
            mapping=lambda a, b: (2 * a - 1, 2 * b - 1))
        lset = N.sqrt(N.x * N.x + N.y * N.y) - 0.62 + 0.05 * N.x * N.y
    else:
        mesh = N.MakeStructured3DMesh(
            hexes=False, nx=3, ny=3, nz=3,
            mapping=lambda a, b, c: (2 * a - 1, 2 * b - 1, 2 * c - 1))
        lset = (N.sqrt(N.x * N.x + N.y * N.y + N.z * N.z) - 0.62
                + 0.05 * N.x * N.y)
    lsa = N.LevelSetMeshAdaptation(mesh, order=order, threshold=10.0, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        deform = lsa.CalcDeformation(lset)
    return mesh, lsa, deform


@pytest.mark.parametrize("dt", ["NEG", "POS", "IF"])
def test_integrate_deformed(dt):
    """``Integrate`` over NEG, POS and IF of a polynomial, of a
    GridFunction's gradient and of the mesh size, under the deformation
    given as ``deformation=`` and set by ``SetDeformation``; with
    ``deformation=`` the mesh holds none after the call."""
    out = {}
    for N, kw in PKGS:
        mesh, lsa, deform = _setup(N, kw, "trig", order=3)
        ld = {"levelset": lsa.lset_p1, "domain_type": getattr(N, dt)}
        g = N.grad(lsa.lset_ho)
        cfs = (N.x * N.x + N.y, g[0] * g[0] + N.y * g[1],
               N.specialcf.mesh_size)
        vals = [N.Integrate(ld, cf, mesh, order=6, deformation=deform)
                for cf in cfs]
        assert mesh.deformation is None
        mesh.SetDeformation(deform)
        vals += [N.Integrate(ld, cf, mesh, order=6) for cf in cfs]
        mesh.UnsetDeformation()
        undeformed = N.Integrate(ld, cfs[0], mesh, order=6)
        out[N] = (np.array(vals), undeformed)
    np.testing.assert_allclose(out[T][0], out[J][0], rtol=1e-12, atol=0)
    assert np.array_equal(out[T][0][:3], out[T][0][3:])
    assert abs(out[T][0][0] - out[T][1]) > 1e-6  # the deformation counts


def _forms(N, kw, et, builder, own):
    """Assemble one integral of ``builder`` under the deformation (set on
    the mesh, or the integral's ``own``) -> (matrix, vector or None)."""
    mesh, lsa, deform = _setup(N, kw, et)
    lsetp1 = lsa.lset_p1
    d = mesh.dim
    ci = N.CutInfo(mesh, lsetp1)
    hasneg, hasif = ci.GetElementsOfType(N.HASNEG), ci.GetElementsOfType(N.IF)
    facets = N.GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif)
    V = N.H1(mesh, order=2, dgjumps=True, **kw)
    u, v = V.TnT()
    x, y, h, grad = N.x, N.y, N.specialcf.mesh_size, N.grad
    nl = 1.0 / N.Norm(grad(lsetp1)) * grad(lsetp1)
    neg = {"levelset": lsetp1, "domain_type": N.NEG}
    ifd = {"levelset": lsetp1, "domain_type": N.IF}
    dkw = {"deformation": deform} if own else {}
    a, f = N.BilinearForm(V), N.LinearForm(V)
    if builder == "volume":
        a += N.SymbolicBFI(form=grad(u) * grad(v) + h * (1 + x) * u * v,
                           **dkw)
        f += N.SymbolicLFI(form=(x * x + y) * v, **dkw)
    elif builder == "cut volume":
        a += N.SymbolicBFI(neg, form=grad(u) * grad(v) + (1 + y) * u * v,
                           definedonelements=hasneg, **dkw)
        f += N.SymbolicLFI(neg, form=(x - y) * v, definedonelements=hasneg,
                           **dkw)
    elif builder == "IF":
        a += N.SymbolicBFI(ifd, form=-(grad(u) * nl) * v
                           - (grad(v) * nl) * u + 10.0 / h * u * v, **dkw)
        f += N.SymbolicLFI(ifd, form=(1 + x) * v, **dkw)
    elif builder == "facet patch":
        a += N.SymbolicFacetPatchBFI(
            form=0.1 / (h * h) * (u - u.Other()) * (v - v.Other()),
            definedonelements=facets, **dkw)
        f = None
    elif builder == "skeleton":
        n = N.specialcf.normal(d)
        a += N.SymbolicBFI(
            form=0.1 * h * N.dnjump(u, 1) * N.dnjump(v, 1)
            + h ** 3 * N.dnjump(u, 2) * N.dnjump(v, 2)
            + ((grad(u) - grad(u.Other())) * n) * (v + v.Other()),
            skeleton=True, definedonelements=facets, **dkw)
        f = None
    elif builder == "element boundary":
        n = N.specialcf.normal(d)
        a += N.SymbolicBFI(form=(grad(u) * n) * v + h * u * v,
                           element_boundary=True, **dkw)
        f = None
    elif builder == "BND":
        a += N.SymbolicBFI(form=(1 + x) * u * v, VOL_or_BND=N.BND, **dkw)
        f += N.SymbolicLFI(form=(x + y) * v, VOL_or_BND=N.BND, **dkw)
    if not own:
        mesh.SetDeformation(deform)
    a.Assemble()
    if f is not None:
        f.Assemble()
    mesh.UnsetDeformation()
    return a.mat, (None if f is None else f.vec)


BUILDERS = ["volume", "cut volume", "IF", "facet patch", "skeleton",
            "element boundary", "BND"]


@pytest.mark.parametrize("et,builder,own",
                         [("trig", b, False) for b in BUILDERS]
                         + [("tet", b, False) for b in BUILDERS[2:]]
                         + [("quad", "facet patch", False),
                            ("trig", "facet patch", True),
                            ("tet", "IF", True)])
def test_context_builders_deformed(et, builder, own):
    """Every context builder of ``forms/assemble.py`` under a deformation:
    the matrix and the vector equal the JAX package's to 1e-12 of the
    largest entry."""
    (Aj, fj), (At, ft) = (_forms(N, kw, et, builder, own) for N, kw in PKGS)
    _close(_dense(At), _dense(Aj))
    if fj is not None:
        _close(_vec(ft), _vec(fj))


def test_facet_patch_newton_fallback_warns(monkeypatch):
    """With ``config.newton_debug`` a facet-patch point whose Newton map
    misses its tolerance is counted and reported (a deformation too strong
    for eight steps from the affine guess)."""
    from ngsxfem_tpu_torch.utils.diagnostics import (
        NewtonNonConvergenceWarning)

    monkeypatch.setattr(T.config, "newton_debug", True)
    mesh, lsa, deform = _setup(T, CPU, "trig")
    deform.vec.data = deform.vec.data * 40.0
    ci = T.CutInfo(mesh, lsa.lset_p1)
    facets = T.GetFacetsWithNeighborTypes(
        mesh, a=ci.GetElementsOfType(T.HASNEG), b=ci.GetElementsOfType(T.IF))
    V = T.H1(mesh, order=2, dgjumps=True, **CPU)
    u, v = V.TnT()
    a = T.BilinearForm(V)
    a += T.SymbolicFacetPatchBFI(form=(u - u.Other()) * (v - v.Other()),
                                 definedonelements=facets,
                                 deformation=deform)
    with pytest.warns(NewtonNonConvergenceWarning, match="facet-patch"):
        a.Assemble()


def test_kept_plan_follows_the_deformation():
    """``LinearForm`` keeps its scatter plan for the same dof stream: an
    assembly under a second deformation equals a fresh form's."""
    mesh, lsa, deform = _setup(T, CPU, "trig")
    V = T.H1(mesh, order=2, **CPU)
    ld = {"levelset": lsa.lset_p1, "domain_type": T.NEG}
    u, v = V.TnT()

    def forms():
        f = T.LinearForm(V)
        f += T.SymbolicLFI(ld, form=(1 + T.x) * v)
        a = T.BilinearForm(V)
        a += T.SymbolicBFI(ld, form=T.grad(u) * T.grad(v))
        return a, f

    a, f = forms()
    mesh.SetDeformation(deform)
    f.Assemble()
    a.Assemble()
    first = f.vec.NumPy().copy()
    other = T.GridFunction(lsa.deform_space)
    other.vec.data = 0.5 * deform.vec.data
    mesh.SetDeformation(other)
    f.Assemble()
    a.Assemble()
    a2, f2 = forms()
    f2.Assemble()
    a2.Assemble()
    mesh.UnsetDeformation()
    assert np.abs(f.vec.NumPy() - first).max() > 1e-8
    assert np.array_equal(f.vec.NumPy(), f2.vec.NumPy())
    assert np.array_equal(_dense(a.mat), _dense(a2.mat))


def _jax_example(name):
    import importlib

    return importlib.import_module(f"examples.{name}")


@pytest.mark.parametrize("name,tkw,jkw", [
    ("fictdom3d", dict(nx=4, order=2, isoparametric=True),
     dict(nx=4, order=2, isoparametric=True)),
    ("nxfem_higher_order", dict(nx=8), dict(nx=8)),
    ("tracefem", dict(nx=8, order=2), dict(nx=8, order=2)),
])
def test_examples_match_jax(name, tkw, jkw):
    """The isoparametric examples of the port against the JAX examples:
    L2 errors within 1e-8 relative."""
    from importlib import import_module

    mod = import_module(f"ngsxfem_tpu_torch.examples.{name}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        et = mod.run(verbose=False, device="cpu", **tkw)
        ej = _jax_example(name).run(verbose=False, **jkw)
    et, ej = np.atleast_1d(et)[0], np.atleast_1d(ej)[0]
    assert abs(et - ej) <= 1e-8 * abs(ej), (et, ej)


def test_workload_limits():
    """The limits of ``tests/test_workloads.py`` on the port's examples:
    the restricted form (nx=16: fewer stored entries than the full
    pattern, L2 < 0.02), ``nxfem_higher_order`` (nx=15, order 3: L2 <
    1e-3) and ``fictdom3d(isoparametric=True)`` (order 2, nx = 8, 16: e1 <
    1.5e-3, e1 / e2 > 6)."""
    from ngsxfem_tpu_torch.examples import (
        fictdom3d, fictdom_ghostpen_restrictedblf, nxfem_higher_order)

    err, nnz_full, nnz_restr = fictdom_ghostpen_restrictedblf.run(
        nx=16, verbose=False, device="cpu")
    assert nnz_restr < nnz_full and err < 0.02, (err, nnz_full, nnz_restr)
    err = nxfem_higher_order.run(nx=15, order=3, verbose=False, device="cpu")
    assert err < 1e-3, err
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        e1 = fictdom3d.run(nx=8, order=2, verbose=False, isoparametric=True,
                           device="cpu")
    e2 = fictdom3d.run(nx=16, order=2, verbose=False, isoparametric=True,
                       device="cpu")
    assert e1 < 1.5e-3 and e1 / e2 > 6.0, (e1, e2)


def test_other_examples_converge():
    """``tests/test_tracefem.py``'s limits on the port's ``tracefem3d``
    (order 2, deformed; nx=6 L2 < 0.06, nx=12 below a sixth of it) and
    ``traceconverg`` (mean EOC over nx = 8, 16, 32 above 1.75 at order 1
    and 2.7 at order 2), and ``stokesxfem`` with ``deform=True`` (errors
    that fall under refinement); the mesh holds no deformation
    afterwards."""
    from ngsxfem_tpu_torch.examples import (stokesxfem, traceconverg,
                                            tracefem3d)

    e6 = tracefem3d.run(nx=6, verbose=False, device="cpu")
    e12 = tracefem3d.run(nx=12, verbose=False, device="cpu")
    assert e6 < 0.06 and e12 < e6 / 6, (e6, e12)
    res = traceconverg.run(orders=(1, 2), levels=3, verbose=False,
                           device="cpu")
    for order, limit in ((1, 1.75), (2, 2.7)):
        eocs = res[order][1]
        assert sum(eocs) / len(eocs) > limit, res[order]
    u8, p8 = stokesxfem.run(nx=8, deform=True, verbose=False, device="cpu")
    u16, p16 = stokesxfem.run(nx=16, deform=True, verbose=False,
                              device="cpu")
    assert u16 < u8 / 3 and p16 < p8 / 2 and u16 < 1e-3, (u8, p8, u16, p16)


def test_chip_smoke_iso_phase_on_cpu(monkeypatch):
    """The checks of chip_smoke.py's phase 19 on the CPU at nx=8 (the
    predicate ``sparse._on_card`` patched so that the default
    ``Inverse()`` takes its card branch on CPU tensors; they launch no
    kernel): path ``device_cg``, products == iterations + 1, ``a.mat``
    symmetric, the true residual, no shift-Newton warning, the deformation
    unset afterwards; ``ell_asym`` sees an asymmetric table."""
    import chip_smoke as cs
    from ngsxfem_tpu_torch.solvers import sparse

    monkeypatch.setattr(sparse, "_on_card", lambda mat: True)
    b = cs.iso_card(T, 2, 8, torch.device("cpu"), detail=False)
    assert b["path"] == "device_cg" and b["launches"] == 0
    assert b["products"] == b["iters"] + 1 and b["true_rel"] <= 1e-10
    assert b["asym"] <= 1e-12 and b["K"] == 104 and b["err"] < 1.5e-3
    m = T.SparseMatrix([0, 0, 1], [0, 1, 1],
                       torch.tensor([2.0, 1.0, 3.0], dtype=torch.float64),
                       (2, 2), device="cpu")
    assert cs.ell_asym(m.ell()) == 1.0 / 3.0
