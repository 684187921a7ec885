"""``Integrate`` of the port against the JAX package.

Meshes of every element type (1D/2D/3D, a mapped quad mesh among them),
seeded random P1 level sets fed to both packages as the same numpy dof
vector, CoefficientFunction level sets (interpolated to P1 by
``ensure_p1_levelset``), NEG/POS/IF, orders 0-8, ``element_wise``, and the
README's Quick start: the port (tensors on the CPU, float64) agrees with
the JAX package (CPU, x64) to 1e-12 relative.  Also: the autograd gradient
of a cut volume against ``jax.grad``, and the features that raised before
they were ported (``subdivlvl``, ``time_order``, ``deformation``) give the
JAX package's values.
"""
import math
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu_torch.integrate import _cut_ctx_and_weights, ensure_p1_levelset

RTOL = 1e-12


def _meshes(pkg, et):
    """The same mesh from either package."""
    if et == "segm":
        return pkg.Make1DMesh(5)
    if et in ("trig", "quad"):
        return pkg.MakeStructured2DMesh(quads=et == "quad", nx=4, ny=4)
    if et == "mquad":
        return pkg.MakeStructured2DMesh(
            quads=True, nx=3, ny=3, mapping=lambda a, b: (a + 0.2 * b * b, b))
    return pkg.MakeStructured3DMesh(hexes=et == "hex", nx=2, ny=2, nz=2)


def _integrand(pkg, et):
    if et == "segm":
        return 1 + pkg.x * pkg.x
    if et in ("tet", "hex"):
        return 1 + pkg.x * pkg.y - pkg.sin(pkg.z)
    return 1 + pkg.x * pkg.y + pkg.exp(pkg.y)


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    return np.all(np.abs(a - b) <= rtol * np.maximum(np.abs(a), 1e-3))


def _pair_lset(et, seed):
    """JAX and port meshes with one seeded random P1 level set."""
    mj, mt = _meshes(J, et), _meshes(T, et)
    lj = J.GridFunction(J.H1(mj, order=1))
    lt = T.GridFunction(T.H1(mt, order=1, device="cpu"))
    vals = np.random.default_rng(seed).standard_normal(lj.space.ndof)
    lj.vec.data = jnp.asarray(vals)
    lt.vec.data = vals
    return mj, mt, lj, lt


ORDERS = {"trig": range(9), "segm": (0, 3, 8), "quad": (0, 2, 5, 8),
          "mquad": (1, 4), "tet": (0, 2, 5, 8), "hex": (0, 3, 6)}


@pytest.mark.parametrize("et,order", [(et, o) for et, os in ORDERS.items()
                                      for o in os])
def test_integrate_matches_jax(et, order):
    mj, mt, lj, lt = _pair_lset(et, seed=order + 10 * len(et))
    fj, ft = _integrand(J, et), _integrand(T, et)
    for dt in ("NEG", "POS", "IF"):
        a = J.Integrate({"levelset": lj, "domain_type": getattr(J, dt)}, fj,
                        mj, order=order)
        b = T.Integrate({"levelset": lt, "domain_type": getattr(T, dt)}, ft,
                        mt, order=order)
        assert _close(a, b), (dt, a, b)


@pytest.mark.parametrize("et", ["trig", "hex"])
def test_element_wise_and_plain(et):
    mj, mt, lj, lt = _pair_lset(et, seed=3)
    fj, ft = _integrand(J, et), _integrand(T, et)
    for dt in ("NEG", "IF"):
        a = J.Integrate({"levelset": lj, "domain_type": getattr(J, dt)}, fj,
                        mj, order=3, element_wise=True)
        b = T.Integrate({"levelset": lt, "domain_type": getattr(T, dt)}, ft,
                        mt, order=3, element_wise=True)
        assert b.shape == (mt.ne,) and _close(a, b.numpy())
        r = T.Integrate({"levelset": lt, "domain_type": getattr(T, dt)}, ft,
                        mt, order=3, region_wise=True)
        assert _close(r, [b.sum().item()])
    # no level set: the plain integral over the mesh
    a = J.Integrate(fj, mj, order=4)
    b = T.Integrate(ft, mt, order=4, device="cpu")
    assert _close(a, b)


@pytest.mark.parametrize("et", ["segm", "quad", "tet"])
def test_cf_levelset_through_ensure_p1(et):
    """A CoefficientFunction level set is interpolated to P1 on the device
    the caller names, with the reference's warning when its P1 space is
    built: the first Integrate warns, the next ones reuse the P1
    GridFunction cached on the CF (as the JAX package does)."""
    mj, mt = _meshes(J, et), _meshes(T, et)
    lj = J.sqrt(J.x * J.x + J.y * J.y + J.z * J.z) - 0.45
    lt = T.sqrt(T.x * T.x + T.y * T.y + T.z * T.z) - 0.45
    for k, dt in enumerate(("NEG", "POS", "IF")):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            a = J.Integrate({"levelset": lj, "domain_type": getattr(J, dt)},
                            _integrand(J, et), mj, order=4)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            b = T.Integrate({"levelset": lt, "domain_type": getattr(T, dt)},
                            _integrand(T, et), mt, order=4, device="cpu")
        built = [w for w in rec if "not a P1 GridFunction" in str(w.message)]
        assert len(built) == (1 if k == 0 else 0), (dt, len(built))
        assert _close(a, b), (dt, a, b)
    with pytest.warns(UserWarning):
        gf = ensure_p1_levelset(lt, mt, device="cpu")
    assert gf.space.order == 1 and gf.device.type == "cpu"


def test_p1_levelset_cache_reuse_and_bitwise():
    """``ensure_p1_levelset(cache_on=)``: a second call reuses the P1 space
    and GridFunction without a warning, re-interpolates, and gives bits
    equal to a cold call; a changed CF on the same holder is rebuilt."""
    mt = _meshes(T, "tet")
    lt = T.sqrt(T.x * T.x + T.y * T.y + T.z * T.z) - 0.45
    holder = type("Holder", (), {})()
    with pytest.warns(UserWarning, match="not a P1 GridFunction"):
        g1 = ensure_p1_levelset(lt, mt, "cpu", cache_on=holder)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g2 = ensure_p1_levelset(lt, mt, "cpu", cache_on=holder)
    assert g2 is g1 and g2.space is g1.space
    with pytest.warns(UserWarning):
        cold = ensure_p1_levelset(lt, mt, "cpu")
    assert cold is not g1 and torch.equal(cold.vec.data, g2.vec.data)
    ld = {"levelset": lt, "domain_type": T.NEG}
    with pytest.warns(UserWarning):
        first = T.Integrate(ld, 1.0, mt, order=3, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = T.Integrate(ld, 1.0, mt, order=3, device="cpu")
    with pytest.warns(UserWarning):
        fresh = T.Integrate({"levelset": lt - 0.0, "domain_type": T.NEG}, 1.0,
                            mt, order=3, device="cpu")
    assert first == again == fresh
    other = T.sqrt(T.x * T.x + T.y * T.y + T.z * T.z) - 0.3
    with pytest.warns(UserWarning):
        g3 = ensure_p1_levelset(other, mt, "cpu", cache_on=holder)
    assert g3 is not g1


@pytest.mark.parametrize("et", ["trig", "tet"])
def test_p1_levelset_cache_after_refine(et):
    """After ``mesh.Refine()`` the cached P1 level set of the old mesh is
    not served: the next Integrate of the same CF gives the refined mesh's
    value, equal to a fresh CF's there.  (The JAX package keys its cache on
    the mesh alone and raises a shape error here.)"""
    mt = _meshes(T, et)
    lt = T.sqrt(T.x * T.x + T.y * T.y + T.z * T.z) - 0.45
    with pytest.warns(UserWarning):
        coarse = T.Integrate({"levelset": lt, "domain_type": T.NEG}, 1.0, mt,
                             order=2, device="cpu")
    v0 = mt._version
    mt.Refine()
    assert mt._version > v0 and mt._views == {}
    with pytest.warns(UserWarning):
        fine = T.Integrate({"levelset": lt, "domain_type": T.NEG}, 1.0, mt,
                           order=2, device="cpu")
    fresh_cf = T.sqrt(T.x * T.x + T.y * T.y + T.z * T.z) - 0.45
    with pytest.warns(UserWarning):
        ref = T.Integrate({"levelset": fresh_cf, "domain_type": T.NEG}, 1.0,
                          mt, order=2, device="cpu")
    assert fine == ref and fine != coarse
    gf = ensure_p1_levelset(lt, mt, "cpu", cache_on=lt)
    assert gf.space.ndof == mt.nv


def test_single_tier_matches_two_tier():
    """``_cut_ctx_and_weights`` (cut rule on every element) integrates like
    the two-tier ``Integrate``, and like the JAX package's version."""
    from ngsxfem_tpu.integrate import _cut_ctx_and_weights as jax_ctw
    from ngsxfem_tpu_torch.cf.context import eval_pure as t_eval
    from ngsxfem_tpu.cf.context import eval_pure as j_eval

    mj, mt, lj, lt = _pair_lset("tet", seed=5)
    fj, ft = _integrand(J, "tet"), _integrand(T, "tet")
    for dt in ("NEG", "IF"):
        ctx, w, m = _cut_ctx_and_weights(mt, lt, getattr(T, dt), 3)
        b = float((torch.where(m, torch.broadcast_to(t_eval(ft, ctx), w.shape),
                               0.0) * w).sum())
        cj, wj, mj_ = jax_ctw(mj, lj, getattr(J, dt), 3)
        a = float(jnp.sum(jnp.where(mj_, jnp.broadcast_to(j_eval(fj, cj),
                                                          wj.shape), 0.0) * wj))
        c = T.Integrate({"levelset": lt, "domain_type": getattr(T, dt)}, ft,
                        mt, order=3)
        assert _close(a, b) and _close(b, c), (dt, a, b, c)


def test_quick_start():
    """README's Quick start, run by both packages (the port on the CPU)."""
    mesh = J.MakeStructured2DMesh(quads=False, nx=32, ny=32)
    lsetp1 = J.GridFunction(J.H1(mesh, order=1))
    J.InterpolateToP1(J.sqrt(J.x * J.x + J.y * J.y) - 0.5, lsetp1)
    a = J.Integrate({"levelset": lsetp1, "domain_type": J.NEG},
                    J.CoefficientFunction(1.0), mesh, order=4)

    mesh = T.MakeStructured2DMesh(quads=False, nx=32, ny=32)
    lsetp1 = T.GridFunction(T.H1(mesh, order=1, device="cpu"))
    T.InterpolateToP1(T.sqrt(T.x * T.x + T.y * T.y) - 0.5, lsetp1)
    b = T.Integrate({"levelset": lsetp1, "domain_type": T.NEG},
                    T.CoefficientFunction(1.0), mesh, order=4)
    assert _close(a, b) and abs(b - math.pi / 16) < 1e-3


def test_autograd_matches_jax_grad():
    """d(NEG volume)/dr of a ball through the cut rule, torch.autograd
    against jax.grad (tests/test_misc.py:331-343, at nx=4)."""
    from ngsxfem_tpu.ops.straightcut import cut_rule_element as j_rule
    from ngsxfem_tpu.mesh.mesh import map_points as j_map, det_and_inv as j_det
    from ngsxfem_tpu_torch.ops.straightcut import cut_rule_element as t_rule
    from ngsxfem_tpu_torch.mesh.mesh import map_points as t_map
    from ngsxfem_tpu_torch.mesh.mesh import det_and_inv as t_det

    m = T.MakeStructured3DMesh(hexes=False, nx=4, ny=4, nz=4)
    dist = np.sqrt(((m.vertices_np - 0.5) ** 2).sum(1))[m.elements_np]
    coords = m.vertices_np[m.elements_np]

    def vol_j(r):
        rule = j_rule("tet", jnp.asarray(dist) - r, 2)
        _, Jm = j_map("tet", jnp.asarray(coords), rule.pts)
        return jnp.sum(rule.w * (rule.side == 0) * jnp.abs(j_det(Jm)[0]))

    r = torch.tensor(0.31, dtype=torch.float64, requires_grad=True)
    rule = t_rule("tet", torch.as_tensor(dist) - r, 2)
    _, Jm = t_map("tet", torch.as_tensor(coords), rule.pts)
    vol = (rule.w * (rule.side == 0) * t_det(Jm)[0].abs()).sum()
    vol.backward()
    gj = float(jax.grad(vol_j)(0.31))
    assert abs(float(r.grad) - gj) <= 1e-10 * abs(gj)
    assert abs(float(vol) - float(vol_j(0.31))) <= 1e-13


PLANES = {1: (lambda m: 0.78522 - m.x, {"NEG": 1 - 0.78522, "POS": 0.78522,
                                          "IF": 1.0}),
          2: (lambda m: 1 - 2 * m.x - 2 * m.y,
              {"NEG": 7 / 8, "POS": 1 / 8, "IF": 1 / math.sqrt(2)}),
          3: (lambda m: 1 - 2 * m.x - 2 * m.y - 2 * m.z,
              {"NEG": 47 / 48, "POS": 1 / 48, "IF": math.sqrt(3) / 8})}


@pytest.mark.parametrize("et,n", [("segm", 1), ("trig", 1), ("trig", 10),
                                  ("quad", 1), ("quad", 10), ("tet", 1),
                                  ("tet", 2), ("hex", 1), ("hex", 2)])
@pytest.mark.parametrize("order", [2, 4, 8])
def test_straight_cut_exactness(et, n, order):
    """The reference suite's exactness cases on the port
    (tests/test_straightcutrule.py:17-137): plane level sets through mesh
    vertices (exact zeros), error <= 5e-15 (k+1)^2 against the exact
    value."""
    d = {"segm": 1, "trig": 2, "quad": 2, "tet": 3, "hex": 3}[et]
    if d == 1:
        mesh = T.Make1DMesh(n)
    elif d == 2:
        mesh = T.MakeStructured2DMesh(quads=et == "quad", nx=n, ny=n)
    else:
        mesh = T.MakeStructured3DMesh(hexes=et == "hex", nx=n, ny=n, nz=n)
    lset_cf, ref = PLANES[d]
    lset = T.GridFunction(T.H1(mesh, order=1, device="cpu"))
    T.InterpolateToP1(lset_cf(T), lset)
    for dt, val in ref.items():
        got = T.Integrate({"levelset": lset, "domain_type": getattr(T, dt)},
                          T.CoefficientFunction(1), mesh, order=order)
        assert abs(got - val) < 5e-15 * (order + 1) ** 2, (dt, got, val)


def test_unported_features_raise():
    mesh = T.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    lset = T.GridFunction(T.H1(mesh, order=1, device="cpu"))
    lset.Set(T.x - 0.3)
    ld = {"levelset": lset, "domain_type": T.NEG}
    # space-time integrals are ported (ROADMAP A13): ``time_order`` in the
    # dict or as an argument, and CutInfo's, give the JAX package's values
    mj = J.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    lj = J.GridFunction(J.H1(mj, order=1))
    lj.Set(J.x - 0.3)
    ldj = {"levelset": lj, "domain_type": J.NEG}
    # the subdivision rule is ported (ROADMAP A8b): on the P1 level set and
    # on a CoefficientFunction, in space and in space-time, it gives the JAX
    # package's values
    assert _close(T.Integrate(dict(ld, subdivlvl=1), 1.0, mesh),
                  J.Integrate(dict(ldj, subdivlvl=1), 1.0, mj))
    spatial = (T.x * T.x + T.y - 0.5, J.x * J.x + J.y - 0.5)
    moving = (T.x - 0.3 - 0.2 * T.tref, J.x - 0.3 - 0.2 * J.tref)
    for (lt, lj_), kw in ((spatial, {}), (spatial, {"time_order": 1}),
                          (moving, {"time_order": 1})):
        assert _close(
            T.Integrate({"levelset": lt, "domain_type": T.IF,
                         "subdivlvl": 2}, 1 + T.x, mesh, device="cpu", **kw),
            J.Integrate({"levelset": lj_, "domain_type": J.IF,
                         "subdivlvl": 2}, 1 + J.x, mj, **kw))
    f_t, f_j = 1 + T.x * T.tref, 1 + J.x * J.tref
    assert _close(T.Integrate(dict(ld, time_order=0), f_t, mesh),
                  J.Integrate(dict(ldj, time_order=0), f_j, mj))
    assert _close(T.Integrate(ld, f_t, mesh, time_order=0),
                  J.Integrate(ldj, f_j, mj, time_order=0))
    # deformations are ported (ROADMAP A11): a zero one changes nothing and
    # is unset after the call
    zero = T.GridFunction(T.VectorH1(mesh, order=1, device="cpu"))
    assert T.Integrate(ld, 1.0, mesh, deformation=zero) == \
        T.Integrate(ld, 1.0, mesh)
    assert mesh.deformation is None
    ci_t, ci_j = T.CutInfo(mesh, lset, time_order=0), J.CutInfo(mj, lj,
                                                                time_order=0)
    assert np.array_equal(ci_t.dt_of_elem, ci_j.dt_of_elem)
    assert _close(ci_t.GetCutRatios(), np.asarray(ci_j.GetCutRatios()))


def test_entry_points_need_a_device(monkeypatch):
    """Without a card and without device="cpu" the general API raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = T.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    for call in (lambda: T.GridFunction(T.H1(mesh, order=1)),
                 lambda: T.H1(mesh, order=1).el2dof,
                 lambda: T.Integrate(T.x, mesh, order=1),
                 lambda: T.CutInfo(mesh, T.x - 0.3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                call()
    gf = T.GridFunction(T.H1(mesh, order=1), device="cpu")
    assert gf.vec.data.device.type == "cpu"
    assert gf.vec.data.dtype == torch.float64
