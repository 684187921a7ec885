"""Isoparametric level-set mesh adaptation of the PyTorch port against the
JAX package.

The same level sets go through ``LevelSetMeshAdaptation`` of both packages
(tensors on the CPU, float64) on trig, quad and tet meshes (2D nx <= 16, 3D
nx <= 4): the deformation vector, ``lset_ho`` and ``lset_p1`` to 1e-12
absolute for orders 2 and 3, every blending variant (``CF(0.0)`` equal to
none exactly), ``ProjectShift`` with ``active_elements`` and with
``[lower, upper]``, ``CalcMaxDistance``/``CalcDistances`` and their free
functions to 1e-12 relative, ``shifted_eval`` at the setting of
``tests/test_workloads.py::test_shifted_eval``; the convergence checks of
``tests/test_lsetcurv.py`` run on the port with their thresholds; the
refinement hooks set the JAX package's flags; periodic spaces (ROADMAP
A9d) raise.
"""
import warnings
from math import log as mlog, pi

import numpy as np
import pytest
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu.utils.diagnostics import (
    NewtonNonConvergenceWarning as JWarn)
from ngsxfem_tpu_torch.utils.diagnostics import (
    NewtonNonConvergenceWarning as TWarn)

CPU = {"device": "cpu"}
PKGS = ((J, {}), (T, CPU))


def _np(gf):
    return np.asarray(gf.vec.NumPy() if hasattr(gf.vec, "NumPy")
                      else gf.vec.data)


def _jnp(gf):
    return np.asarray(gf._arr)


def _mesh(N, et, nx):
    if et in ("trig", "quad"):
        return N.MakeStructured2DMesh(quads=et == "quad", nx=nx, ny=nx,
                                      mapping=lambda a, b: (2 * a - 1,
                                                            2 * b - 1))
    return N.MakeStructured3DMesh(hexes=False, nx=nx, ny=nx, nz=nx,
                                  mapping=lambda a, b, c: (2 * a - 1,
                                                           2 * b - 1,
                                                           2 * c - 1))


def _lset(N, dim):
    r2 = N.x * N.x + N.y * N.y + (N.z * N.z if dim == 3 else 0.0)
    # not a pure circle: a perturbed one, so every node moves differently
    return N.sqrt(r2) - 0.62 + 0.05 * N.x * N.y


def _adapted(N, kw, et, nx, order, threshold=10.0, **calc):
    mesh = _mesh(N, et, nx)
    lsa = N.LevelSetMeshAdaptation(mesh, order=order, threshold=threshold,
                                   **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lsa.CalcDeformation(_lset(N, mesh.dim), **calc)
    return mesh, lsa


@pytest.mark.parametrize("et,nx,order", [("trig", 8, 2), ("trig", 8, 3),
                                         ("quad", 6, 2), ("tet", 3, 2),
                                         ("tet", 3, 3)])
def test_deformation_matches_jax(et, nx, order):
    (_, lj), (_, lt) = (_adapted(N, kw, et, nx, order) for N, kw in PKGS)
    for name in ("lset_ho", "lset_p1", "deform"):
        a, b = _np(getattr(lt, name)), _jnp(getattr(lj, name))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-12, (name, np.abs(a - b).max())
    assert np.abs(_np(lt.deform)).max() > 1e-4  # it moved something
    assert lt.deform.vec.data.device.type == "cpu"


@pytest.mark.parametrize("blending", ["none", "quadratic", "quartic", "cf0",
                                      "number"])
def test_blending_matches_jax(blending):
    """The blending variants (reference lsetcurving/lsetcurv.py:118-152)
    against the JAX package; ``CF(0.0)`` gives none's deformation exactly,
    and the blended ones deform no more than none."""
    out = {}
    for N, kw in PKGS:
        arg = {"none": None, "quadratic": "quadratic", "quartic": "quartic",
               "cf0": N.CoefficientFunction(0.0), "number": 0.25}[blending]
        _, lsa = _adapted(N, kw, "trig", 8, 3, threshold=1000, blending=arg)
        out[N] = lsa
    a, b = _np(out[T].deform), _jnp(out[J].deform)
    assert np.abs(a - b).max() <= 1e-12
    _, none = _adapted(T, CPU, "trig", 8, 3, threshold=1000)
    if blending == "cf0":
        assert torch.equal(out[T].deform.vec.data, none.deform.vec.data)
    assert np.abs(a).max() <= np.abs(_np(none.deform)).max() + 1e-14


def test_project_shift_bands_match_jax():
    """``ProjectShift`` with an explicit ``active_elements`` band and with
    a ``[lower, upper]`` band, against the JAX package."""
    res = {}
    for N, kw in PKGS:
        mesh, lsa = _adapted(N, kw, "trig", 8, 2)
        dfs = N.GridFunction(lsa.deform_space, **kw)
        dlu = N.GridFunction(lsa.deform_space, **kw)
        marks = np.zeros(mesh.ne, dtype=bool)
        marks[::3] = True
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            N.ProjectShift(lsa.lset_ho, lsa.lset_p1, dfs,
                           active_elements=N.BitArray(marks), threshold=10.0)
            N.ProjectShift(lsa.lset_ho, lsa.lset_p1, dlu, lower=-0.2,
                           upper=0.1, threshold=10.0)
        res[N] = (dfs, dlu, lsa)
    for k in range(2):
        a, b = _np(res[T][k]), _jnp(res[J][k])
        assert np.abs(a - b).max() <= 1e-12
    # the wider band moves more dofs than the cut elements alone
    assert (np.count_nonzero(_np(res[T][1]))
            > np.count_nonzero(_np(res[T][2].deform)))


@pytest.mark.parametrize("et,nx,order", [("trig", 8, 2), ("tet", 3, 2)])
def test_distances_match_jax(et, nx, order):
    """``CalcMaxDistance``, ``CalcDistances`` and the free functions
    against the JAX package (1e-12 relative); the mesh holds no deformation
    after any of them."""
    vals = {}
    for N, kw in PKGS:
        mesh, lsa = _adapted(N, kw, et, nx, order)
        ls = _lset(N, mesh.dim)
        v = [lsa.CalcMaxDistance(ls), *lsa.CalcDistances(ls),
             N.CalcMaxDistance(ls, lsa.lset_p1, lsa.deform),
             *N.CalcDistances(ls, lsa.lset_p1, lsa.deform),
             N.CalcMaxDistance(lsa.lset_ho, lsa.lset_p1, lsa.deform)]
        assert mesh.deformation is None
        vals[N] = np.array(v)
    np.testing.assert_allclose(vals[T], vals[J], rtol=1e-12, atol=0)
    assert 0 < vals[T][0] < 0.1  # a small distance on these coarse meshes


def test_shifted_eval():
    """``tests/test_workloads.py::test_shifted_eval``'s setting on the
    port, and its value against the JAX package."""
    out = {}
    for N, kw in PKGS:
        mesh = N.MakeStructured2DMesh(quads=False, nx=8, ny=8)
        g = N.GridFunction(N.H1(mesh, order=2, **kw))
        g.Set(N.x * N.x + N.y)
        dgf = N.GridFunction(N.VectorH1(mesh, order=1, **kw))
        dgf.Set(N.CoefficientFunction((0.05, 0.0)))
        err = N.Integrate(None, (N.shifted_eval(g, forth=dgf)
                                 - ((N.x + 0.05) * (N.x + 0.05) + N.y)) ** 2,
                          mesh, order=6, **kw)
        back = N.Integrate(None, N.shifted_eval(g, back=dgf, forth=dgf)
                           * (1 + N.x), mesh, order=6, **kw)
        out[N] = (err, back)
    assert out[T][0] < 1e-15
    assert abs(out[T][1] - out[J][1]) <= 1e-12 * abs(out[J][1])


@pytest.mark.parametrize("order", [2, 3])
def test_maxdist_eoc(order):
    """``tests/test_lsetcurv.py::test_maxdist_eoc`` on the port: mean EOC
    of the max distance over nx = 8, 16, 32 above the order."""
    r = 2.0 / 3.0
    dists = []
    for i in range(3):
        mesh = _mesh(T, "trig", 8 * 2**i)
        lsa = T.LevelSetMeshAdaptation(mesh, order=order, threshold=10.0,
                                       **CPU)
        lset = T.sqrt(T.x * T.x + T.y * T.y) - r
        lsa.CalcDeformation(lset)
        dists.append(lsa.CalcMaxDistance(lset))
    eocs = [mlog(dists[i] / dists[i + 1]) / mlog(2) for i in range(2)]
    assert sum(eocs) / len(eocs) > order, (dists, eocs)


@pytest.mark.parametrize("dt,order", [("IF", 2), ("NEG", 3)])
def test_curved_measure(dt, order):
    """``tests/test_lsetcurv.py``'s ``test_curved_interface_measure`` (IF,
    order 2, nx = 8, 16, 32: final error < 3e-6 and a tenth of the first)
    and ``test_curved_area`` (NEG, order 3, nx=16: error < 1e-5) on the
    port, as one parametrised test."""
    r = 2.0 / 3.0
    exact = 2 * pi * r if dt == "IF" else pi * r * r
    errs = []
    for nx in ((8, 16, 32) if dt == "IF" else (16,)):
        mesh = _mesh(T, "trig", nx)
        lsa = T.LevelSetMeshAdaptation(mesh, order=order, threshold=10.0,
                                       **CPU)
        deform = lsa.CalcDeformation(T.sqrt(T.x * T.x + T.y * T.y) - r)
        val = T.Integrate({"levelset": lsa.lset_p1,
                           "domain_type": getattr(T, dt)},
                          T.CoefficientFunction(1.0), mesh, order=2 * order,
                          deformation=deform)
        assert mesh.deformation is None
        errs.append(abs(val - exact))
    if dt == "IF":
        assert errs[-1] < 3e-6 and errs[-1] < errs[0] / 10, errs
    else:
        assert errs[0] < 1e-5, errs


def test_blending_accuracy():
    """``tests/test_lsetcurv.py::test_blending_variants`` on the port: the
    interface distance with no blending below 5e-5, the blended ones
    within 50x of it."""
    mesh = _mesh(T, "trig", 16)
    phi = T.sqrt(T.x * T.x + T.y * T.y) - 0.6
    dists = {}
    for key, blend in (("none", None), ("quadratic", "quadratic"),
                       ("quartic", "quartic")):
        lsa = T.LevelSetMeshAdaptation(mesh, order=3, threshold=1000, **CPU)
        lsa.CalcDeformation(phi, blending=blend)
        dists[key] = lsa.CalcDistances(phi)[0]
    assert dists["none"] < 5e-5
    for b in ("quadratic", "quartic"):
        assert dists[b] < 50 * dists["none"] + 1e-6, dists


def test_nonconverged_shift_warns():
    """A coarse mesh leaves the shift Newton unconverged: both packages
    warn with their ``NewtonNonConvergenceWarning``, and on the same
    deformation."""
    got = {}
    for (N, kw), W in zip(PKGS, (JWarn, TWarn)):
        mesh = _mesh(N, "tet", 2)
        lsa = N.LevelSetMeshAdaptation(mesh, order=2, threshold=0.2, **kw)
        with pytest.warns(W, match="did not fully converge"):
            lsa.CalcDeformation(N.sqrt(N.x * N.x + N.y * N.y + N.z * N.z)
                                - 0.7)
        got[N] = lsa.deform
    assert np.abs(_np(got[T]) - _jnp(got[J])).max() <= 1e-12


def test_not_ported_raise():
    """The refinement hooks (ROADMAP A14, ported) set the same refinement
    flags as the JAX package; ``periodic=True`` (A9d, ported) needs a
    mesh with a periodic identification, as in the JAX package."""
    marks = {}
    for N, kw in PKGS:
        mesh = _mesh(N, "trig", 4)
        lsa = N.LevelSetMeshAdaptation(mesh, order=2, **kw)
        phi = N.sqrt(N.x * N.x + N.y * N.y) - 0.55
        lsa.CalcDeformation(phi)
        got = [np.asarray(lsa.MarkForRefinement(phi, 0.3).a),
               np.asarray(N.RefineAtLevelSet(lsa.lset_p1, -0.1, 0.1).a)]
        N.CalcDistances(phi, lsa.lset_p1, lsa.deform, refine_threshold=0.3)
        got.append(np.asarray(mesh._refine_marks))
        marks[N] = got
    for a, b in zip(marks[T], marks[J]):
        assert a.any() and np.array_equal(a, b)
    for N, kw in PKGS:
        with pytest.raises(ValueError, match="no periodic identification"):
            N.LevelSetMeshAdaptation(_mesh(N, "trig", 4), periodic=True,
                                     **kw)
