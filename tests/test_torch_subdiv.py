"""Subdivision quadrature (``subdivlvl > 0``) of the port against the JAX
package, on the cases of ``tests/test_backuprule.py`` with the same ids.

A level set given as a CoefficientFunction goes through ``Integrate``,
``SymbolicBFI``/``SymbolicLFI`` and the space-time rule of both packages
(JAX on the CPU in float64, the port with tensors on the CPU): every value
agrees to 1e-12 (relative to the value, at least 1; matrices to 1e-12 of
their largest entry), and the reference suite's own contracts (straight
cuts exact to 5e-15 (k+1)^2, circle EOC > 1.75, ~4x per level, the moving
interface, the banded tiers equal to the uniform rule) hold on the port.

The reference measures an interface triangle by the square root of a Gram
determinant, which cancels for the sliver sub-simplices the 3D subdivision
makes and leaves ~1e-10 of spurious measure; the port takes the cross
product.  As in ``test_torch_cutrule.py``, the JAX package runs here with
that measure swapped in (``_gram_measure_exact``).
"""
from math import pi, log

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu.ops import straightcut as jax_sc

CPU = {"device": "cpu"}
TOL = 1e-12


def _gram_measure_exact(edges):
    """The reference's ``_gram_measure`` with the interface-triangle area
    taken from the cross product (no cancellation)."""
    k, g = edges.shape[-2], edges.shape[-1]
    if k == 2 and g == 3:
        det = jnp.sum(jnp.cross(edges[..., 0, :], edges[..., 1, :]) ** 2, -1)
    elif k == 1 and g > 1:
        det = jnp.sum(edges[..., 0, :] ** 2, -1)
    else:
        return _GRAM_REF(edges)
    pos = det > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, det, 1.0)), 0.0)


_GRAM_REF = jax_sc._gram_measure


@pytest.fixture(autouse=True)
def _exact_gram(monkeypatch):
    monkeypatch.setattr(jax_sc, "_gram_measure", _gram_measure_exact)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _same(t, j, tol=TOL):
    assert abs(t - j) <= tol * max(1.0, abs(j)), (t, j)


def _integrate_both(make_mesh, make_lset, ld_extra, cf=1.0, **kw):
    """The same Integrate in both packages: (port value, JAX value)."""
    out = []
    for N, dev in ((T, CPU), (J, {})):
        mesh = make_mesh(N)
        ld = dict(ld_extra, levelset=make_lset(N))
        ld["domain_type"] = getattr(N, ld["domain_type"])
        c = cf(N) if callable(cf) else N.CoefficientFunction(cf)
        out.append(N.Integrate(levelset_domain=ld, cf=c, mesh=mesh, **kw,
                               **dev))
    return out


@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("order", [2, 8])
@pytest.mark.parametrize("domain", ["NEG", "POS", "IF"])
@pytest.mark.parametrize("lvl", [1, 2])
def test_subdiv_straight_cut_2d_exact(order, domain, quad, lvl):
    ref = {"NEG": 7 / 8, "POS": 1 / 8, "IF": 1 / np.sqrt(2)}[domain]
    t, j = _integrate_both(
        lambda N: N.MakeStructured2DMesh(quads=quad, nx=2, ny=2),
        lambda N: 1 - 2 * N.x - 2 * N.y,
        {"domain_type": domain, "subdivlvl": lvl}, order=order)
    assert abs(t - ref) < 5e-15 * (order + 1) ** 2
    _same(t, j)


@pytest.mark.parametrize("hex_", [True, False])
@pytest.mark.parametrize("order", [2, 8])
@pytest.mark.parametrize("domain", ["NEG", "POS", "IF"])
def test_subdiv_straight_cut_3d_exact(order, domain, hex_):
    ref = {"NEG": 47 / 48, "POS": 1 / 48, "IF": np.sqrt(3) / 8}[domain]
    t, j = _integrate_both(
        lambda N: N.MakeStructured3DMesh(hexes=hex_, nx=1, ny=1, nz=1),
        lambda N: 1 - 2 * N.x - 2 * N.y - 2 * N.z,
        {"domain_type": domain, "subdivlvl": 1}, order=order)
    assert abs(t - ref) < 5e-15 * (order + 1) ** 2
    _same(t, j)


@pytest.mark.parametrize("domain", ["NEG", "POS", "IF"])
def test_subdiv_circle_eoc(domain):
    r = 0.6
    ref = {"POS": 1 - pi * r * r / 4, "NEG": pi * r * r / 4,
           "IF": r * pi / 2}[domain]
    errors = []
    for n in (2, 4, 8, 16, 32):
        t, j = _integrate_both(
            lambda N: N.MakeStructured2DMesh(quads=False, nx=n, ny=n),
            lambda N: N.sqrt(N.x * N.x + N.y * N.y) - r,
            {"domain_type": domain, "subdivlvl": 1}, order=4)
        _same(t, j)
        errors.append(abs(t - ref))
    eoc = [log(errors[i] / errors[i + 1]) / log(2) for i in range(4)]
    assert sum(eoc[1:]) / 3 > 1.75, (errors, eoc)


@pytest.mark.parametrize("domain", ["NEG", "IF"])
def test_subdiv_level_convergence(domain):
    r = 0.6
    ref = {"NEG": pi * r * r / 4, "IF": r * pi / 2}[domain]
    errors = []
    for lvl in (1, 2, 3, 4):
        t, j = _integrate_both(
            lambda N: N.MakeStructured2DMesh(quads=False, nx=2, ny=2),
            lambda N: N.sqrt(N.x * N.x + N.y * N.y) - r,
            {"domain_type": domain, "subdivlvl": lvl}, order=4)
        _same(t, j)
        errors.append(abs(t - ref))
    ratios = [errors[i] / errors[i + 1] for i in range(3)]
    assert min(ratios) > 2.5, (errors, ratios)
    assert sum(ratios) / 3 > 3.4, (errors, ratios)


def test_subdiv_assembly_matches_p1_on_linear_lset():
    def mass(N, dev, subdiv):
        mesh = N.MakeStructured2DMesh(quads=True, nx=4, ny=4)
        V = N.H1(mesh, order=1, **dev)
        u, v = V.TnT()
        levelset = 1 - 2 * N.x - 2 * N.y
        if subdiv:
            ld = {"levelset": levelset, "domain_type": N.NEG, "subdivlvl": 1}
        else:
            lsp1 = N.GridFunction(N.H1(mesh, order=1, **dev))
            N.InterpolateToP1(levelset, lsp1)
            ld = {"levelset": lsp1, "domain_type": N.NEG}
        a = N.BilinearForm(V)
        a += N.SymbolicCutBFI(ld, form=u * v, force_intorder=4)
        a.Assemble()
        return _np(a.mat.todense())

    A_p1, A_sd = mass(T, CPU, False), mass(T, CPU, True)
    assert np.abs(A_p1 - A_sd).max() < 1e-13
    A_j = mass(J, {}, True)
    assert np.abs(A_sd - A_j).max() <= TOL * np.abs(A_j).max()


def test_subdiv_interface_lfi():
    r = 0.6

    def load(N, dev):
        mesh = N.MakeStructured2DMesh(quads=True, nx=4, ny=4)
        V = N.H1(mesh, order=1, **dev)
        _, v = V.TnT()
        f = N.LinearForm(V)
        f += N.SymbolicCutLFI({"levelset": N.sqrt(N.x * N.x + N.y * N.y) - r,
                               "domain_type": N.IF, "subdivlvl": 2}, form=v)
        f.Assemble()
        return _np(f.vec.data if N is T else f.vec)

    t, j = load(T, CPU), load(J, {})
    assert abs(t.sum() - r * pi / 2) < 1e-3
    assert np.abs(t - j).max() <= TOL * np.abs(j).max()


def test_subdiv_moving_interface_reassembles():
    out = {}
    for N, dev in ((T, CPU), (J, {})):
        mesh = N.MakeStructured2DMesh(quads=True, nx=4, ny=4)
        V = N.H1(mesh, order=1, **dev)
        u, v = V.TnT()
        rp = N.Parameter(0.5)
        a = N.BilinearForm(V)
        a += N.SymbolicCutBFI({"levelset": N.sqrt(N.x * N.x + N.y * N.y) - rp,
                               "domain_type": N.NEG, "subdivlvl": 2},
                              form=u * v, force_intorder=4)
        a.Assemble()
        s1 = _np(a.mat.todense()).sum()
        rp.Set(0.8)
        a.Assemble()
        out[N] = (s1, _np(a.mat.todense()).sum())
    s1, s2 = out[T]
    assert abs(s1 - pi * 0.25 / 4) < 2e-3
    assert abs(s2 - pi * 0.64 / 4) < 2e-3
    for t, j in zip(out[T], out[J]):
        _same(t, j)


def test_subdiv_unsupported_kinds_raise():
    mesh = T.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    V = T.H1(mesh, order=1, **CPU)
    u, v = V.TnT()
    ld = {"levelset": T.sqrt(T.x * T.x + T.y * T.y) - 0.6,
          "domain_type": T.NEG, "subdivlvl": 1}
    for kw in ({"skeleton": True}, {"element_boundary": True},
               {"VOL_or_BND": T.BND}):
        a = T.BilinearForm(V)
        a += T.SymbolicCutBFI(ld, form=u * v, **kw)
        with pytest.raises(NotImplementedError, match="subdivlvl"):
            a.Assemble()


# -- space-time subdivision ----------------------------------------------------

@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("domain,ref", [("NEG", 7 / 8), ("POS", 1 / 8),
                                        ("IF", 0.5)])
def test_subdiv_spacetime_exact(quad, domain, ref):
    t, j = _integrate_both(
        lambda N: N.MakeStructured2DMesh(quads=quad, nx=1, ny=1),
        lambda N: 1 - 2 * N.x - 2 * N.tref,
        {"domain_type": domain, "subdivlvl": 1}, order=1, time_order=1)
    assert abs(t - ref) < 5e-14
    _same(t, j)


@pytest.mark.parametrize("domain", ["NEG", "IF"])
def test_subdiv_spacetime_level_convergence(domain):
    r0 = 0.5
    exact = pi * r0 * r0 if domain == "NEG" else 2 * pi * r0
    errs = []
    for lvl in (1, 2, 3):
        t, j = _integrate_both(
            lambda N: N.MakeStructured2DMesh(
                quads=False, nx=8, ny=8,
                mapping=lambda a, b: (2 * a - 1, 2 * b - 1)),
            lambda N: N.sqrt((N.x - 0.2 * N.tref) ** 2 + N.y * N.y) - r0,
            {"domain_type": domain, "subdivlvl": lvl}, order=2, time_order=2)
        _same(t, j)
        errs.append(abs(t - exact))
    for e0, e1 in zip(errs, errs[1:]):
        assert e0 / e1 > 2.5, errs


def test_subdiv_spacetime_assembly_matches_p1_st():
    def mat(N, dev, sub, to):
        mesh = N.MakeStructured2DMesh(quads=False, nx=3, ny=3)
        st = N.SpaceTimeFESpace(N.H1(mesh, order=1, **dev), N.ScalarTimeFE(1))
        u, v = st.TnT()
        lev = N.x - 0.3 - 0.4 * N.tref
        if sub:
            ld = {"levelset": lev, "domain_type": N.NEG, "subdivlvl": 1}
        else:
            lgf = N.GridFunction(st, **dev)
            N.SpaceTimeInterpolateToP1(lev, N.tref, lgf)
            ld = {"levelset": lgf, "domain_type": N.NEG}
        a = N.BilinearForm(st)
        a += N.SymbolicCutBFI(ld, form=u * v, time_order=to)
        a.Assemble()
        return _np(a.mat.todense())

    A2, B2 = mat(T, CPU, True, 2), mat(T, CPU, False, 2)
    assert abs(A2.sum() - 0.5) < 1e-13
    assert abs(B2.sum() - 0.5) < 1e-13
    assert np.abs(A2 - B2).max() < 5e-4
    A6, B6 = mat(T, CPU, True, 6), mat(T, CPU, False, 6)
    assert np.abs(A6 - B6).max() < 1e-13
    for to, A in ((2, A2), (6, A6)):
        Aj = mat(J, {}, True, to)
        assert np.abs(A - Aj).max() <= TOL * np.abs(Aj).max()


def test_subdiv_spacetime_moving_slab_no_recompile():
    dtt = 0.25
    vols = {}
    for N, dev in ((T, CPU), (J, {})):
        mesh = N.MakeStructured2DMesh(quads=False, nx=4, ny=4)
        st = N.SpaceTimeFESpace(N.H1(mesh, order=1, **dev), N.ScalarTimeFE(1))
        u, v = st.TnT()
        t0 = N.Parameter(0.0)
        lev = N.x - 0.2 - 0.5 * (t0 + dtt * N.tref)
        a = N.BilinearForm(st)
        a += N.SymbolicCutBFI({"levelset": lev, "domain_type": N.NEG,
                               "subdivlvl": 1}, form=u * v, time_order=2)
        vols[N] = []
        for s in range(3):
            t0.Set(s * dtt)
            a.Assemble()
            vols[N].append(_np(a.mat.todense()).sum())
    for s, (t, j) in enumerate(zip(vols[T], vols[J])):
        exact = 0.2 + 0.5 * (s * dtt + dtt / 2)
        assert abs(t - exact) < 1e-12, (s, t, exact)
        _same(t, j)


def test_subdiv_banded_matches_uniform():
    """The three tiers of ``Integrate`` equal the uniform rule on every
    element (``subdiv_ctx_and_weights``, the forms' rule), and the JAX
    package's banded values."""
    from ngsxfem_tpu_torch.cf.context import eval_pure
    from ngsxfem_tpu_torch.integrate import subdiv_ctx_and_weights

    for dim, lvl, tol in ((2, 2, 5e-14), (3, 2, 5e-13)):
        vals = {}
        for N, dev in ((T, CPU), (J, {})):
            if dim == 2:
                mesh = N.MakeStructured2DMesh(quads=False, nx=7, ny=7)
                ls = N.sqrt(N.x * N.x + N.y * N.y) - 0.55
            else:
                mesh = N.MakeStructured3DMesh(hexes=False, nx=5, ny=5, nz=5)
                ls = N.sqrt(N.x * N.x + N.y * N.y + N.z * N.z) - 0.55
            f = 1.0 + N.x + N.y * N.y
            for dom in ("NEG", "POS", "IF"):
                vals[(N, dom)] = N.Integrate(
                    {"levelset": ls, "domain_type": getattr(N, dom),
                     "subdivlvl": lvl}, cf=f, mesh=mesh, order=4, **dev)
                if N is T:
                    ctx, w, mask = subdiv_ctx_and_weights(
                        mesh, ls, getattr(N, dom), 4, lvl,
                        torch.device("cpu"))
                    fv = torch.broadcast_to(eval_pure(f, ctx), w.shape)
                    vals[("uniform", dom)] = float(
                        (torch.where(mask, fv, 0.0) * w).sum())
        for dom in ("NEG", "POS", "IF"):
            a, b = vals[(T, dom)], vals[("uniform", dom)]
            assert abs(a - b) <= tol * max(1.0, abs(b)), (dim, dom, a, b)
            _same(a, vals[(J, dom)])


def test_subdiv_banded_moving():
    """A Parameter-driven level set through the banded tiers tracks the
    geometry (the JAX test's no-recompile contract has no counterpart: the
    port selects the band exactly on every call)."""
    for N, dev in ((T, CPU), (J, {})):
        mesh = N.MakeStructured2DMesh(quads=False, nx=12, ny=12)
        rp = N.Parameter(0.5)
        ld = {"levelset": N.sqrt(N.x * N.x + N.y * N.y) - rp,
              "domain_type": N.NEG, "subdivlvl": 2}
        got = []
        for r in (0.5, 0.55, 0.6):
            rp.Set(r)
            got.append(N.Integrate(ld, cf=1.0, mesh=mesh, order=4, **dev))
        if N is T:
            port = got
            for r, val in zip((0.5, 0.55, 0.6), got):
                assert abs(val - pi * r * r / 4) < 3e-3, (r, val)
        else:
            for t, j in zip(port, got):
                _same(t, j)


def test_subdiv_tiers_select_exactly():
    """The band and the mixed depth-1 children are taken exactly: no pad
    rows, and the children's tier holds only cut children."""
    from ngsxfem_tpu_torch.integrate import subdiv_tiers

    mesh = T.MakeStructured2DMesh(quads=False, nx=6, ny=6)
    ls = T.sqrt(T.x * T.x + T.y * T.y) - 0.55
    tiers = subdiv_tiers(mesh, ls, T.NEG, 2, 2, torch.device("cpu"))
    plain, desc, cut = tiers
    lat = T.Integrate({"levelset": ls, "domain_type": T.IF, "subdivlvl": 2},
                      cf=1.0, mesh=mesh, order=2, element_wise=True, **CPU)
    band = set(torch.nonzero(lat > 0)[:, 0].tolist())
    assert set(desc[3].tolist()) >= band
    assert set(cut[3].tolist()) <= set(desc[3].tolist())
    assert not set(plain[3].tolist()) & set(desc[3].tolist())
    assert all(w.shape[0] == len(ids) for _, w, _, ids in tiers)
