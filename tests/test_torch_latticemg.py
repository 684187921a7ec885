"""Lattice DIA multigrid of the PyTorch port against the JAX package.

The same numpy-seeded inputs go through ``ngsxfem_tpu.solvers.latticemg``
and ``ngsxfem_tpu_torch.solvers.latticemg`` on the CPU in float64:
``_interp_axis``/``_restrict_axis`` to 1e-14 and the transpose identity to
1e-12; ``prepare`` (``dinv``, ``ainv0``, ``ainv0_res``) and one ``apply`` on
the [4, 8, 16] hierarchy to 1e-10 relative; the MG-CG iteration count
within 1 of the reference's.  ``prepare_safe`` takes the host fallback on
the Hilbert system of tests/test_latticemg.py and not on the real
hierarchy (there at n=12: the n=9 system that defeats the reference's
f32-seeded branch is within reach of a native f64 inverse); the port has no
Newton-Schulz branch, so ``force_ns=True``
raises.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from ngsxfem_tpu.config import config as jax_cfg
from ngsxfem_tpu.models.poisson import UnfittedPoisson as JaxPoisson
from ngsxfem_tpu.solvers import krylov as jax_krylov
from ngsxfem_tpu.solvers import latticemg as jax_lmg
from ngsxfem_tpu.solvers.sparse import dia_matvec as jax_dia_matvec
from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
from ngsxfem_tpu_torch.solvers import krylov
from ngsxfem_tpu_torch.solvers import latticemg as lmg
from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

NXS = [4, 8, 16]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _masks(m, d):
    ge = m.lset_np[m.mesh.elements_np]
    eps = jax_cfg.lset_eps
    ge = np.where(np.abs(ge) < eps, np.where(ge >= 0, eps, -eps), ge)
    cut = (ge < 0).any(1) & (ge > 0).any(1)
    ifd = np.zeros(m.ndof, bool)
    ifd[m.space.el2dof_np[cut].ravel()] = True
    act = m.active_dofs[d["perm_inv"]]
    return act, (ifd & m.active_dofs)[d["perm_inv"]]


def _level_jax(nx):
    m = JaxPoisson(nx=nx, dim=3, order=1, dtype=jnp.float64)
    d = m.dia_structure()
    dd = {k: (jnp.asarray(v) if "slots" in k else v) for k, v in d.items()}
    # one call per input: eager, not jit (its compile took minutes)
    with jax.disable_jit():
        V, _ = m.assemble_vals_lattice(m.vertices, m.lset, dd)
    return (d["offsets"], np.asarray(V)) + _masks(m, d)


def _level_torch(nx):
    m = UnfittedPoisson(nx=nx, dim=3, order=1, dtype=torch.float64,
                        device="cpu")
    d = m.dia_structure()
    V, _ = m.assemble_vals_lattice(m.vertices, m.lset, d)
    return (d["offsets"], V.numpy()) + _masks(m, d)


@pytest.fixture(scope="module")
def levels_jax():
    return [_level_jax(n) for n in NXS]


@pytest.fixture(scope="module")
def levels_torch():
    return [_level_torch(n) for n in NXS]


def _mg(mod, levs, **kw):
    return mod.LatticeDIAMG([lv[0] for lv in levs], [n + 1 for n in NXS],
                            dim=3, active_masks=[lv[2] for lv in levs],
                            if_masks=[None] + [lv[3] for lv in levs[1:]], **kw)


@pytest.mark.parametrize("dim,nc", [(1, 7), (2, 5), (3, 4)])
def test_transfers_match_reference_and_transpose(dim, nc):
    rng = np.random.default_rng(dim)
    nf = 2 * nc - 1
    xc = rng.standard_normal((nc,) * dim)
    yf = rng.standard_normal((nf,) * dim)
    for ax in range(dim):
        pj = np.asarray(jax_lmg._interp_axis(jnp.asarray(xc), ax))
        pt = lmg._interp_axis(torch.as_tensor(xc), ax)
        assert pt.shape == pj.shape and np.abs(pt.numpy() - pj).max() <= 1e-14
        rj = np.asarray(jax_lmg._restrict_axis(jnp.asarray(yf), ax))
        rt = lmg._restrict_axis(torch.as_tensor(yf), ax)
        assert rt.shape == rj.shape and np.abs(rt.numpy() - rj).max() <= 1e-14
    px, ry = torch.as_tensor(xc), torch.as_tensor(yf)
    for ax in range(dim):
        px = lmg._interp_axis(px, ax)
        ry = lmg._restrict_axis(ry, ax)
    lhs = float((px * torch.as_tensor(yf)).sum())
    rhs = float((torch.as_tensor(xc) * ry).sum())
    assert abs(lhs - rhs) < 1e-12 * max(1.0, abs(lhs))


def test_prolongation_reproduces_linears():
    nc = 5
    g = np.linspace(0.0, 1.0, nc)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    p = torch.as_tensor(2.0 * X - 0.5 * Y + 3.0 * Z + 1.0)
    for ax in range(3):
        p = lmg._interp_axis(p, ax)
    gf = np.linspace(0.0, 1.0, 2 * nc - 1)
    Xf, Yf, Zf = np.meshgrid(gf, gf, gf, indexing="ij")
    assert np.allclose(p.numpy(), 2.0 * Xf - 0.5 * Yf + 3.0 * Zf + 1.0,
                       atol=1e-13)


def test_lattice_levels_match_reference(levels_jax, levels_torch):
    """Each package's own level: offsets and masks bitwise, tables 1e-12."""
    for lj, lt in zip(levels_jax, levels_torch):
        assert np.array_equal(np.asarray(lj[0]), np.asarray(lt[0]))
        assert np.abs(lj[1] - lt[1]).max() <= 1e-12 * np.abs(lj[1]).max()
        assert np.array_equal(lj[2], lt[2]) and np.array_equal(lj[3], lt[3])


def test_params_device_and_dtypes(levels_jax):
    mt = _mg(lmg, levels_jax)
    p = mt.params([lv[1] for lv in levels_jax], device="cpu")
    assert p["vals"][0].dtype == torch.float64       # config.dtype
    assert p["act"][0].dtype == torch.bool
    assert p["if"][0] is None and p["if"][1].dtype == torch.float64
    p32 = mt.params([lv[1] for lv in levels_jax], dtype=torch.float32,
                    device="cpu")
    assert p32["vals"][2].dtype == p32["if"][2].dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mt.params([lv[1] for lv in levels_jax])


def test_prepare_and_apply_match_reference(levels_jax):
    """Same f64 tables (the reference's) through both packages."""
    vals = [lv[1] for lv in levels_jax]
    mj, mt = _mg(jax_lmg, levels_jax), _mg(lmg, levels_jax)
    ppj = mj.prepare(mj.params(vals, dtype=jnp.float64))
    ppt = mt.prepare(mt.params(vals, dtype=torch.float64, device="cpu"))
    for dj, dt in zip(ppj["dinv"], ppt["dinv"]):
        assert _rel(dt.numpy(), dj) <= 1e-14
    assert ppt["ainv0"].dtype == torch.float64
    assert _rel(ppt["ainv0"].numpy(), ppj["ainv0"]) <= 1e-10
    assert float(ppt["ainv0_res"]) < 1e-8
    assert abs(float(ppt["ainv0_res"]) - float(ppj["ainv0_res"])) < 1e-8
    b = np.random.default_rng(3).standard_normal(vals[-1].shape[1])
    zj = np.asarray(mj.apply(ppj, jnp.asarray(b)))
    zt = mt.apply(ppt, torch.as_tensor(b))
    assert zt.dtype == torch.float64
    assert _rel(zt.numpy(), zj) <= 1e-10
    # a stored f32 inverse keeps the f64 residual report
    pp32 = mt.prepare(mt.params(vals, dtype=torch.float32, device="cpu"))
    assert pp32["ainv0"].dtype == torch.float32
    assert pp32["ainv0_res"].dtype == torch.float64


@pytest.mark.parametrize("kw", [{}, {"if_iters": 0}, {"nsmooth": 1,
                                                      "damping": 0.8}])
def test_apply_options_match_reference(levels_jax, kw):
    vals = [lv[1] for lv in levels_jax]
    mj, mt = _mg(jax_lmg, levels_jax, **kw), _mg(lmg, levels_jax, **kw)
    ppj = mj.prepare(mj.params(vals, dtype=jnp.float64))
    ppt = mt.prepare(mt.params(vals, dtype=torch.float64, device="cpu"))
    b = np.random.default_rng(4).standard_normal(vals[-1].shape[1])
    assert _rel(mt.apply(ppt, torch.as_tensor(b)).numpy(),
                np.asarray(mj.apply(ppj, jnp.asarray(b)))) <= 1e-10


def test_mg_cg_matches_reference_and_beats_jacobi(levels_jax, levels_torch):
    """The slice end to end: each package on its own hierarchy."""
    TOL = 1e-8
    mj, mt = _mg(jax_lmg, levels_jax), _mg(lmg, levels_torch)
    ppj = mj.prepare(mj.params([lv[1] for lv in levels_jax],
                               dtype=jnp.float64))
    ppt = mt.prepare(mt.params([lv[1] for lv in levels_torch],
                               dtype=torch.float64, device="cpu"))
    offs = levels_jax[-1][0]
    bj = jnp.asarray(np.where(levels_jax[-1][2], 1.0, 0.0))
    xj, kj, _ = jax_krylov.cg(
        lambda z: jax_dia_matvec(offs, ppj["vals"][-1], z), bj,
        M=lambda r: mj.apply(ppj, r), maxiter=100, tol=TOL)
    bt = torch.as_tensor(np.where(levels_torch[-1][2], 1.0, 0.0))
    Vf = ppt["vals"][-1]
    xt, kt, rt = krylov.cg(lambda z: dia_matvec(offs, Vf, z), bt,
                           M=lambda r: mt.apply(ppt, r), maxiter=100, tol=TOL)
    bn = float(torch.linalg.vector_norm(bt))
    assert float(rt) <= TOL * bn * 1.5
    assert abs(kt - int(kj)) <= 1, (kt, int(kj))
    assert _rel(xt.numpy(), np.asarray(xj)) <= 1e-6
    k0 = list(np.asarray(offs)).index(0)
    dinv = torch.where(Vf[k0].abs() > 1e-30, 1.0 / Vf[k0], 1.0)
    _, kjac, _ = krylov.cg(lambda z: dia_matvec(offs, Vf, z), bt,
                           M=lambda r: dinv * r, maxiter=2000, tol=TOL)
    assert kt < kjac / 2, (kt, kjac)


def test_lattice_assembly_repeats_bitwise_f32():
    """No atomics in assemble_vals_lattice: the f32 table repeats bit for
    bit, so the f32 hierarchy (and MG-CG on it) does too."""
    m = UnfittedPoisson(nx=8, dim=3, order=1, dtype=torch.float32,
                        device="cpu")
    d = m.dia_structure()
    V0, _ = m.assemble_vals_lattice(m.vertices, m.lset, d)
    for _ in range(4):
        V, _ = m.assemble_vals_lattice(m.vertices, m.lset, d)
        assert torch.equal(V, V0)


def test_rejects_non_nesting_and_length_mismatch():
    with pytest.raises(ValueError):
        lmg.LatticeDIAMG([[0], [0]], [5, 10], dim=3)
    with pytest.raises(ValueError):
        lmg.LatticeDIAMG([[0], [0]], [5], dim=3)


def test_force_ns_raises():
    mg1 = lmg.LatticeDIAMG([[-1, 0, 1]], [5], dim=1)
    p = mg1.params([np.ones((3, 5))], device="cpu")
    with pytest.raises(NotImplementedError):
        mg1.prepare(p, force_ns=True)
    with pytest.raises(NotImplementedError):
        mg1.prepare_safe(p, force_ns=True)


def _dense_dia(A):
    n = A.shape[0]
    offs = list(range(-(n - 1), n))
    V = np.zeros((len(offs), n))
    for k, o in enumerate(offs):
        i = np.arange(max(0, -o), min(n, n - o))
        V[k][i] = A[i, i + o]
    return offs, V


def test_prepare_dense_coarse_matrix():
    """prepare's dense coarse matrix: a well-conditioned tridiagonal system
    is inverted to f64 accuracy, empty rows become identity rows."""
    n = 65
    L = (np.diag(2.0 * np.ones(n)) + np.diag(-np.ones(n - 1), 1)
         + np.diag(-np.ones(n - 1), -1))
    L[7, :] = 0.0
    L[:, 7] = 0.0
    offs, V = _dense_dia(L)
    mg1 = lmg.LatticeDIAMG([offs], [n], dim=1)
    pg = mg1.prepare(mg1.params([V], device="cpu"))
    assert float(pg["ainv0_res"]) < 1e-10
    L[7, 7] = 1.0
    assert np.abs(pg["ainv0"].numpy() - np.linalg.inv(L)).max() < 1e-10
    assert float(pg["dinv"][0][7]) == 1.0


def test_prepare_safe_guard_on_hilbert():
    """Hilbert systems, as in tests/test_latticemg.py.  At n=9 (cond ~ 5e11,
    where the reference's f32-seeded branch fails and it falls back to the
    host) the f64 device inverse is good and the guard passes; at n=12
    (cond ~ 2e16) no f64 LU inverts it, a host one included, and
    ``prepare_safe`` raises where the reference substitutes the host
    inverse."""
    def hilbert(nh):
        H = 1.0 / (np.arange(nh)[:, None] + np.arange(nh)[None, :] + 1.0)
        offs, Vh = _dense_dia(H)
        mgh = lmg.LatticeDIAMG([offs], [nh], dim=1)
        return H, mgh, mgh.params([Vh], dtype=torch.float64, device="cpu")

    H, mgh, params = hilbert(9)
    ok = mgh.prepare_safe(params)
    assert "ainv0_host_fallback" not in ok
    assert float(ok["ainv0_res"]) < 1e-3
    assert ok["ainv0"].dtype == torch.float64
    xe = np.sin(np.arange(9))
    x = ok["ainv0"].numpy() @ (H @ xe)
    assert np.linalg.norm(x - xe) / np.linalg.norm(xe) < 1e-2
    with pytest.raises(RuntimeError, match="coarse inverse residual"):
        mgh.prepare_safe(params, res_tol=-1.0)       # forced

    H, mgh, params = hilbert(12)
    assert not (float(mgh.prepare(params)["ainv0_res"]) < 1e-3)
    # the host float64 inverse of the same matrix fails the same guard
    assert not (np.abs(np.eye(12) - H @ np.linalg.inv(H)).max() < 1e-3)
    with pytest.raises(RuntimeError, match="coarse inverse residual"):
        mgh.prepare_safe(params)
    # NaN in the table: the guard sees a non-finite residual
    bad = {**params, "vals": [params["vals"][0] * float("nan")]}
    assert not np.isfinite(float(mgh.prepare(bad)["ainv0_res"]))
    with pytest.raises(RuntimeError, match="coarse inverse residual"):
        mgh.prepare_safe(bad)


def test_prepare_safe_passes_on_good_system(levels_torch):
    mt = _mg(lmg, levels_torch)
    for dt in (torch.float64, torch.float32):
        pp = mt.prepare_safe(mt.params([lv[1] for lv in levels_torch],
                                       dtype=dt, device="cpu"))
        assert "ainv0_host_fallback" not in pp
        assert float(pp["ainv0_res"]) < 1e-3
        assert pp["ainv0"].dtype == dt
