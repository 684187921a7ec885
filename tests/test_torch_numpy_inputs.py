"""Numpy inputs wherever the JAX package takes them.

The JAX package's functions are built from ``jnp`` ops, which take numpy
arrays, lists and numpy dtypes.  ``tools/torch_parity.py --numpy`` runs the
JAX package's own tests against the port with ``import numpy as jnp``; the
sites of the port where that run found a numpy value or dtype refused are
held here, one case each.  Every case feeds the same seeded numpy inputs to
the JAX function (on the CPU) and to the port's function with the CPU asked
for (``config.resolve_device`` defaulting to the CPU, as
``tools/torch_parity.py`` does), and checks

- the port's numpy call equals its tensor call bit for bit, and its
  tensors lie on the CPU;
- the port's result equals the JAX function's within the JAX test's own
  tolerance (relative to the largest entry of the reference).

Also here: the host helpers ``warn_nonconverged`` and ``config.np_dtype``,
the raise of a numpy call with no card and no CPU asked for, and
``chip_smoke.py`` phase 31 on the CPU.
"""
import importlib
import os
import sys
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T

tconfig = importlib.import_module("ngsxfem_tpu_torch.config")

CPU = {"device": "cpu"}


@pytest.fixture
def cpu_default(monkeypatch):
    """Entry points called without a device use the CPU: the caller asks
    for it, as ``tools/torch_parity.py``'s conftest does, in every module
    of the port that took ``config.resolve_device``."""
    resolve = tconfig.resolve_device

    def cpu(device=None):
        return resolve("cpu" if device is None else device)

    for name, mod in list(sys.modules.items()):
        if (name.split(".")[0] == "ngsxfem_tpu_torch"
                and getattr(mod, "resolve_device", None) is resolve):
            monkeypatch.setattr(mod, "resolve_device", cpu)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _leaves(r):
    if isinstance(r, (tuple, list)):
        return [x for e in r for x in _leaves(e)]
    if hasattr(r, "_fields"):
        return [x for e in r for x in _leaves(e)]
    return [r]


# -- the cases: each returns (JAX result, port numpy call, port tensor call)

def _spd(n, seed, cond_exp=2):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = (Q * (10.0 ** rng.uniform(-cond_exp, 0, n))) @ Q.T
    return 0.5 * (A + A.T), rng.standard_normal(n)


def case_cg():
    from ngsxfem_tpu.solvers.krylov import cg as jcg, jacobi_preconditioner
    from ngsxfem_tpu_torch.solvers.krylov import cg, jacobi_preconditioner as tj

    A, b = _spd(30, 1)
    d = np.diag(A).copy()
    Aj, At = jnp.asarray(A), _t(A)
    ref = jcg(lambda v: Aj @ v, b, M=jacobi_preconditioner(d), maxiter=200,
              tol=1e-12)
    got = cg(lambda v: At @ v, b, M=tj(d), maxiter=200, tol=1e-12)
    ten = cg(lambda v: At @ v, _t(b), M=tj(_t(d)), maxiter=200, tol=1e-12)
    return ref[0], got[0], ten[0]


def case_minres():
    from ngsxfem_tpu.solvers.krylov import minres as jminres
    from ngsxfem_tpu_torch.solvers.krylov import minres

    rng = np.random.default_rng(0)
    A = rng.standard_normal((12, 12))
    A = A + A.T + 14 * np.eye(12)
    B = rng.standard_normal((4, 12))
    K = np.block([[A, B.T], [B, np.zeros((4, 4))]])
    b = rng.standard_normal(16)
    Kj, Kt = jnp.asarray(K), _t(K)
    ref = jminres(lambda v: Kj @ v, b, maxiter=400, tol=1e-12)
    got = minres(lambda v: Kt @ v, b, maxiter=400, tol=1e-12)
    ten = minres(lambda v: Kt @ v, _t(b), maxiter=400, tol=1e-12)
    return ref[0], got[0], ten[0]


def case_cg_ir():
    from ngsxfem_tpu.solvers.krylov import cg_ir as jcg_ir
    from ngsxfem_tpu_torch.solvers.krylov import cg_ir, jacobi_preconditioner

    A, b = _spd(60, 3, cond_exp=3)
    b32 = b.astype(np.float32)
    d32 = np.diag(A).astype(np.float32)
    A32j, A64j = jnp.asarray(A, dtype=jnp.float32), jnp.asarray(A)
    A32t, A64t = _t(A).float(), _t(A)
    ref = jcg_ir(lambda v: A32j @ v, lambda v: A64j @ v, b32,
                 M=lambda r: (1.0 / d32) * r, outer=8, inner=60)
    got = cg_ir(lambda v: A32t @ v, lambda v: A64t @ v, b32,
                M=jacobi_preconditioner(d32), outer=8, inner=60)
    ten = cg_ir(lambda v: A32t @ v, lambda v: A64t @ v, _t(b32),
                M=jacobi_preconditioner(_t(d32)), outer=8, inner=60)
    return ref[0], got[0], ten[0]


def case_jacobi_preconditioner():
    from ngsxfem_tpu.solvers.krylov import jacobi_preconditioner as jjac
    from ngsxfem_tpu_torch.solvers.krylov import jacobi_preconditioner

    rng = np.random.default_rng(4)
    d = rng.standard_normal(40)
    d[::7] = 0.0
    free = rng.random(40) > 0.3
    r = rng.standard_normal(40)
    return (jjac(d, free)(r), jacobi_preconditioner(d, free)(_t(r)),
            jacobi_preconditioner(_t(d), _t(free))(_t(r)))


def case_masked_matvec():
    from ngsxfem_tpu.solvers.krylov import masked_matvec as jmm
    from ngsxfem_tpu_torch.solvers.krylov import masked_matvec

    A, x = _spd(20, 5)
    free = np.random.default_rng(5).random(20) > 0.4
    Aj, At = jnp.asarray(A), _t(A)
    return (jmm(lambda v: Aj @ v, free)(x),
            masked_matvec(lambda v: At @ v, free)(_t(x)),
            masked_matvec(lambda v: At @ v, _t(free))(_t(x)))


def case_dia_matvec():
    from ngsxfem_tpu.solvers.sparse import dia_matvec as jdia
    from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

    rng = np.random.default_rng(6)
    offs = np.array([-9, -3, -1, 0, 1, 3, 9])
    vals, x = rng.standard_normal((7, 50)), rng.standard_normal(50)
    return (jdia(offs, jnp.asarray(vals), x), dia_matvec(offs, vals, x),
            dia_matvec(offs, _t(vals), _t(x)))


def _jax_dia_system(nx=8):
    """The JAX model's f32 DIA table (2D), rhs and Jacobi diagonal (numpy),
    and its lattice's plane size."""
    from ngsxfem_tpu.models.poisson import UnfittedPoisson

    m = UnfittedPoisson(nx=nx, dim=2, order=1, dtype=jnp.float32)
    d = m.dia_structure()
    V, _ = m.assemble_vals_lattice(m.vertices, m.lset, d)
    V = np.asarray(V)
    k0 = int(np.searchsorted(np.asarray(d["offsets"]), 0))
    b = np.where(m.active_dofs[d["perm_inv"]], 1.0, 0.0).astype(np.float32)
    dinv = np.where(np.abs(V[k0]) > 1e-30, 1.0 / V[k0], 1.0).astype(
        np.float32)
    return d["offsets"], V, b, dinv, nx + 1


def case_dia_cg_fused_plane():
    """The CPU path of B1 (``dia_cg_fused_plain``) with the reference's
    ``plane``, against the reference's plain fixed-budget PCG (the JAX
    test's own reference, ``krylov.cg`` on ``dia_matvec``)."""
    from ngsxfem_tpu.solvers.krylov import cg as jcg
    from ngsxfem_tpu.solvers.sparse import dia_matvec as jdia
    from ngsxfem_tpu_torch.solvers.dia_cg import dia_cg_fused

    offs, V, b, dinv, plane = _jax_dia_system()
    Vj = jnp.asarray(V)
    ref = jcg(lambda v: jdia(offs, Vj, v), jnp.asarray(b),
              M=lambda r: dinv * r, maxiter=12, tol=0.0)
    with pytest.raises(ValueError, match="plane"):
        dia_cg_fused(offs, V, b, dinv, 12, plane + 1)
    return (ref[0], dia_cg_fused(offs, V, b, dinv, 12, plane)[0],
            dia_cg_fused(offs, _t(V), _t(b), _t(dinv), 12, plane)[0])


def case_eps_guard():
    from ngsxfem_tpu.ops.straightcut import eps_guard as jeps
    from ngsxfem_tpu_torch.ops.straightcut import eps_guard

    v = np.array([[0.0, -5.5e-17, 3e-15], [-1.0, 2.0, -9.9e-15]])
    return jeps(jnp.asarray(v)), eps_guard(v), eps_guard(_t(v))


def case_cut_rule_simplices():
    from ngsxfem_tpu.ops.straightcut import cut_rule_simplices as jcut
    from ngsxfem_tpu_torch.ops.cuttables import REF_VERTS
    from ngsxfem_tpu_torch.ops.straightcut import cut_rule_simplices

    coords = np.asarray(REF_VERTS["trig"], dtype=np.float64)[None]
    vals = np.array([[-1.0, 1.0, 1.0]])
    return (tuple(jcut(jnp.asarray(coords), jnp.asarray(vals), 2, 2)),
            tuple(cut_rule_simplices(coords, vals, 2, 2)),
            tuple(cut_rule_simplices(_t(coords), _t(vals), 2, 2)))


_MODELS = {}


def _models(nx=8):
    """(JAX, port) UnfittedPoisson at nx (2D, f64), and numpy vertices,
    level set and a seeded vector."""
    from ngsxfem_tpu.models.poisson import UnfittedPoisson

    if nx not in _MODELS:
        mj = UnfittedPoisson(nx=nx, dim=2, order=1, dtype=jnp.float64)
        mt = T.UnfittedPoisson(nx=nx, dim=2, order=1, dtype=torch.float64,
                               **CPU)
        verts = np.asarray(mj.vertices)
        lset = np.asarray(mj.lset)
        x = np.random.default_rng(7).standard_normal(mj.ndof)
        _MODELS[nx] = (mj, mt, verts, lset, x)
    return _MODELS[nx]


def case_model_operator():
    mj, mt, verts, lset, x = _models()
    return (mj.apply(verts, lset, x), mt.operator(verts, lset)(x),
            mt.operator(_t(verts), _t(lset))(_t(x)))


def case_model_apply_compact():
    mj, mt, verts, lset, x = _models()
    vals = lset[mj.mesh.elements_np]
    cap = int(((vals < 0).any(1) & (vals > 0).any(1)).sum()) + 5
    got = mt.apply_compact(verts, lset, x, cap)
    assert torch.isnan(mt.apply_compact(verts, lset, x, 1)).any()
    return (mj.apply_compact(verts, lset, x, cap), got,
            mt.apply_compact(_t(verts), _t(lset), _t(x), cap))


def case_model_assemble_vals_lattice():
    mj, mt, verts, lset, _ = _models()
    dj, dt = mj.dia_structure(), mt.dia_structure()
    return (mj.assemble_vals_lattice(verts, lset, dj)[0],
            mt.assemble_vals_lattice(verts, lset, dt)[0],
            mt.assemble_vals_lattice(_t(verts), _t(lset), dt)[0])


def case_evalctx_dnk_factor():
    """``mesh.device_view`` with the points' numpy dtype: the order-3
    reference-scaled directional derivative factor at numpy points and
    normals (``test_model_review``'s case, at nx=8)."""
    from ngsxfem_tpu.cf.context import EvalCtx as JCtx
    from ngsxfem_tpu.forms.evaluate import _dnk_factor as jdnk
    from ngsxfem_tpu_torch.cf.context import EvalCtx
    from ngsxfem_tpu_torch.forms.evaluate import _dnk_factor

    out = []
    for P, Ctx, dnk, mk in ((J, JCtx, jdnk, jnp.asarray), (T, EvalCtx,
                                                           _dnk_factor, None),
                            (T, EvalCtx, _dnk_factor, _t)):
        mesh = P.MakeStructured2DMesh(quads=False, nx=8, ny=8)
        E = mesh.ne
        pts = np.broadcast_to(np.array([[0.25, 0.25]]), (E, 1, 2))
        nrm = np.broadcast_to(np.array([1.0, 0.0]), (E, 1, 2))
        if mk is not None:
            pts, nrm = mk(np.ascontiguousarray(pts)), mk(
                np.ascontiguousarray(nrm))
        out.append(dnk(mesh.et, 3, 1, Ctx(mesh, pts, normal=nrm)))
    return tuple(out)


def case_hdiv_piola():
    """``fem/space.py``'s views with the points' numpy dtype: the RT0
    Piola shapes and divergence at numpy centroids (``test_hdiv``)."""
    from ngsxfem_tpu.cf.context import EvalCtx as JCtx
    from ngsxfem_tpu_torch.cf.context import EvalCtx

    out = []
    for P, Ctx, mk, dev in ((J, JCtx, jnp.asarray, {}), (T, EvalCtx, None, CPU),
                            (T, EvalCtx, _t, CPU)):
        mesh = P.MakeStructured2DMesh(quads=False, nx=4, ny=4)
        V = P.HDiv(mesh, order=0, **dev)
        cent = np.full((mesh.ne, 1, mesh.dim), 1.0 / 3.0)
        ctx = Ctx(mesh, cent if mk is None else mk(cent))
        out.append(tuple(V._piola(ctx, ctx.ref_pts)))
    return tuple(out)


def case_gf_value_masked():
    """``gf_value`` and a GridFunction of a compressed space evaluated at
    numpy points and element ids (``test_fem_review``)."""
    from ngsxfem_tpu.cf.context import EvalCtx as JCtx, eval_pure as jeval
    from ngsxfem_tpu.fem.gridfunction import gf_value as jgf
    from ngsxfem_tpu_torch.cf.context import EvalCtx, eval_pure
    from ngsxfem_tpu_torch.fem.gridfunction import gf_value

    out = []
    for P, Ctx, ev, gv, mk, dev in (
            (J, JCtx, jeval, jgf, jnp.asarray, {}),
            (T, EvalCtx, eval_pure, gf_value, None, CPU),
            (T, EvalCtx, eval_pure, gf_value, _t, CPU)):
        mesh = P.MakeStructured2DMesh(quads=False, nx=4, ny=4)
        V = P.H1(mesh, order=1, **dev)
        act = np.zeros(V.ndof, bool)
        act[V.el2dof_np[:4].ravel()] = True
        Vc = P.Compress(V, P.BitArray(act))
        gf = P.GridFunction(Vc)
        gf.vec.data = np.linspace(1.0, 2.0, Vc.ndof)
        ids = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 20])
        pts = np.full((len(ids), 2, 2), 0.25)
        pts[:, 1] = 0.5
        if mk is not None:
            ids, pts = mk(ids), mk(pts)
        out.append((ev(gf, Ctx(mesh, pts, elem_ids=ids)),
                    gv(gf, ids, pts)))
    return tuple(out)


def case_facetspace_f32_hook():
    """``FacetFESpace.proxy_factor_hook`` at numpy f32 element-boundary
    points (``test_fem_review``; its f32 tolerance)."""
    from ngsxfem_tpu.cf.context import EvalCtx as JCtx
    from ngsxfem_tpu_torch.cf.context import EvalCtx

    out = []
    for P, Ctx, mk, dev in ((J, JCtx, jnp.asarray, {}), (T, EvalCtx, None, CPU),
                            (T, EvalCtx, _t, CPU)):
        mesh = P.MakeStructured2DMesh(quads=False, nx=3, ny=3)
        F = P.FacetFESpace(mesh, order=1, **dev)
        fr = np.array([[0.25, 0.0], [0.75, 0.0]], dtype=np.float32)
        pts = np.ascontiguousarray(np.broadcast_to(fr, (mesh.ne, 2, 2)))

        class Proxy:
            op = "val"
            block_key = ("f", 0)
            space = F

        ctx = Ctx(mesh, pts if mk is None else mk(pts))
        out.append(F.proxy_factor_hook(Proxy(), None, ctx).arr)
    assert out[1].dtype == torch.float32
    return tuple(out)


def case_fix_t_deformation():
    """``fix_t`` with a per-context deformation at numpy points and times
    (``test_cf_spacetime_review``)."""
    from ngsxfem_tpu.cf.context import EvalCtx as JCtx, eval_pure as jeval
    from ngsxfem_tpu.spacetime import fix_t as jfix, tref as jtref
    from ngsxfem_tpu_torch.cf.context import EvalCtx, eval_pure
    from ngsxfem_tpu_torch.spacetime import fix_t, tref

    out = []
    for P, Ctx, ev, fx, tr, mk, dev in (
            (J, JCtx, jeval, jfix, jtref, jnp.asarray, {}),
            (T, EvalCtx, eval_pure, fix_t, tref, None, CPU),
            (T, EvalCtx, eval_pure, fix_t, tref, _t, CPU)):
        mesh = P.MakeStructured2DMesh(quads=False, nx=2, ny=2)
        deform = P.GridFunction(P.VectorH1(mesh, order=1, **dev))
        deform.Set(P.CoefficientFunction((0.25 * P.x, 0.0 * P.y)))
        pts = np.ascontiguousarray(np.broadcast_to(np.array([[0.2, 0.3]]),
                                                   (mesh.ne, 1, 2)))
        time = np.zeros((mesh.ne, 1))
        if mk is not None:
            pts, time = mk(pts), mk(time)
        ctx = Ctx(mesh, pts, deformation=deform, time=time)
        out.append((ev(fx(P.x + 0.0 * tr, 0.5), ctx), ctx.phys))
    return tuple(out)


def _twogrid(P, dev, free_of):
    """P2TwoGridCL on a P2 reaction-diffusion system (P1 coarse space) with
    the free mask assigned from outside, as ``test_cutmg_api`` assigns its
    active dofs, and a numpy right-hand side."""
    mesh = P.MakeStructured2DMesh(quads=False, nx=4, ny=4)
    mats = []
    for order in (2, 1):
        Vh = P.H1(mesh, order=order, dirichlet=".*", **dev)
        u, v = Vh.TnT()
        a = P.BilinearForm(Vh)
        a += P.SymbolicBFI(form=P.grad(u) * P.grad(v) + u * v)
        a.Assemble()
        f = P.LinearForm(Vh)
        f += P.SymbolicLFI(form=(1.0 + P.x * P.y) * v)
        f.Assemble()
        mats.append((Vh, a.mat, f.vec, Vh.FreeDofs()))
    (V2, A2, b2, free2), (V1, A1, _, free1) = mats
    inv = A1.Inverse(freedofs=free1)
    tg = P.P2TwoGridCL(a=A2, fes=V2, mesh=mesh, linmgiter=lambda r: inv * r,
                       coarse_space=V1, patchtype="edge", nu=2, maxit=30,
                       tol=1e-8)
    tg.free = free_of(np.asarray(free2.np))
    return tg.Mult(np.asarray(b2))


def case_p2twogrid_numpy_free():
    """``P2TwoGridCL.Mult`` with a numpy ``free`` mask and right-hand side
    (``test_cutmg_api``'s calls; solutions to its 1e-8 relative
    residual)."""
    return (_twogrid(J, {}, jnp.asarray), _twogrid(T, CPU, lambda a: a),
            _twogrid(T, CPU, _t))


def _lattice(fname, shape):
    from ngsxfem_tpu.solvers import latticemg as jl
    from ngsxfem_tpu_torch.solvers import latticemg as tl

    a = np.random.default_rng(8).standard_normal(shape)
    out = []
    for fn, arr in ((getattr(jl, fname), jnp.asarray(a)),
                    (getattr(tl, fname), a), (getattr(tl, fname), _t(a))):
        for ax in range(len(shape)):
            arr = fn(arr, ax)
        out.append(arr)
    return tuple(out)


def case_interp_axis():
    return _lattice("_interp_axis", (4, 5, 3))


def case_restrict_axis():
    return _lattice("_restrict_axis", (7, 9, 5))


def _facet_ctx(fn_name, **integ):
    from ngsxfem_tpu.cf.coefficient import wrap as jwrap
    from ngsxfem_tpu.forms import assemble as ja
    from ngsxfem_tpu_torch.cf.coefficient import wrap
    from ngsxfem_tpu_torch.forms import assemble as ta

    out = []
    for P, mod, wr in ((J, ja, jwrap), (T, ta, wrap), (T, ta, wrap)):
        mesh = P.MakeStructured2DMesh(quads=False, nx=3, ny=3)
        res = getattr(mod, fn_name)(mod.Integral(form=wr(1.0), **integ),
                                    mesh, 2)
        ctx = res[0]
        out.append((ctx.normal, ctx.phys) + tuple(res[1:]))
    return tuple(out)


def case_skeleton_ctx_reference_form():
    """``_skeleton_ctx(integral, mesh, order)``, the reference's form."""
    return _facet_ctx("_skeleton_ctx", skeleton=True)


def case_boundary_ctx_reference_form():
    """``_boundary_ctx(integral, mesh, order)``, the reference's form."""
    from ngsxfem_tpu_torch.forms.assemble import BND

    return _facet_ctx("_boundary_ctx", vb=BND)


CASES = {
    # name: (case, relative tolerance of the port vs the JAX function)
    "krylov.cg": (case_cg, 1e-10),
    "krylov.minres": (case_minres, 1e-8),
    "krylov.cg_ir": (case_cg_ir, 1e-7),
    "krylov.jacobi_preconditioner": (case_jacobi_preconditioner, 1e-15),
    "krylov.masked_matvec": (case_masked_matvec, 1e-14),
    "sparse.dia_matvec": (case_dia_matvec, 1e-14),
    "dia_cg.dia_cg_fused(plane)": (case_dia_cg_fused_plane, 5e-5),
    "straightcut.eps_guard": (case_eps_guard, 0.0),
    "straightcut.cut_rule_simplices": (case_cut_rule_simplices, 1e-14),
    "UnfittedPoisson.operator": (case_model_operator, 1e-12),
    "UnfittedPoisson.apply_compact": (case_model_apply_compact, 1e-12),
    "UnfittedPoisson.assemble_vals_lattice":
        (case_model_assemble_vals_lattice, 1e-12),
    "EvalCtx/device_view: _dnk_factor": (case_evalctx_dnk_factor, 1e-12),
    "EvalCtx/space views: HDiv._piola": (case_hdiv_piola, 1e-12),
    "gf_value: compressed space": (case_gf_value_masked, 1e-14),
    "FacetFESpace.proxy_factor_hook f32": (case_facetspace_f32_hook, 1e-6),
    "spacetime fix_t: deformation override": (case_fix_t_deformation, 1e-12),
    "P2TwoGridCL.Mult: numpy free": (case_p2twogrid_numpy_free, 1e-6),
    "latticemg._interp_axis": (case_interp_axis, 1e-15),
    "latticemg._restrict_axis": (case_restrict_axis, 1e-15),
    "assemble._skeleton_ctx(integral, mesh, order)":
        (case_skeleton_ctx_reference_form, 1e-12),
    "assemble._boundary_ctx(integral, mesh, order)":
        (case_boundary_ctx_reference_form, 1e-12),
}


@pytest.mark.parametrize("name", list(CASES))
def test_numpy_inputs_match_tensor_call_and_reference(name, cpu_default):
    fn, tol = CASES[name]
    ref, got, ten = fn()
    ref, got, ten = _leaves(ref), _leaves(got), _leaves(ten)
    assert len(ref) == len(got) == len(ten)
    for r, g, t in zip(ref, got, ten):
        if not torch.is_tensor(g):
            assert g == t and np.asarray(r) == np.asarray(g)
            continue
        assert torch.is_tensor(t) and g.device.type == "cpu"
        assert g.dtype == t.dtype and torch.equal(g, t), name
        r = np.asarray(r)
        g = g.detach().numpy()
        assert r.shape == g.shape, (name, r.shape, g.shape)
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            assert np.array_equal(r, g), name
            continue
        fin = np.isfinite(r)
        assert np.array_equal(fin, np.isfinite(g)), name
        scale = max(np.abs(r[fin]).max(initial=0.0), 1e-300)
        err = np.abs(r[fin] - g[fin]).max(initial=0.0)
        assert err <= tol * scale, (name, err, scale)


# -- host helpers -----------------------------------------------------------

def _warnings_of(fn, *args, **kw):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fn(*args, **kw)
    return [(w.category.__name__, str(w.message)) for w in rec]


@pytest.mark.parametrize("n,total", [(0, 10), (3, 10), (2, None),
                                     (np.int64(4), np.int64(9)),
                                     (torch.tensor(5), 12)])
def test_warn_nonconverged_matches_reference(n, total):
    """Warns iff n > 0, with the reference's category name and text."""
    from ngsxfem_tpu.utils.diagnostics import warn_nonconverged as jwarn
    from ngsxfem_tpu_torch.utils.diagnostics import warn_nonconverged

    want = _warnings_of(jwarn, "shifted_eval Newton", "the unshifted point",
                        int(n), total=total)
    got = _warnings_of(warn_nonconverged, "shifted_eval Newton",
                       "the unshifted point", n, total=total)
    assert got == want and len(got) == (1 if int(n) > 0 else 0)


def test_emit_nonconverged_says_what_warn_says():
    from ngsxfem_tpu_torch.utils.diagnostics import (emit_nonconverged,
                                                     warn_nonconverged)

    assert (_warnings_of(emit_nonconverged, "m", "f", torch.tensor(2), 7)
            == _warnings_of(warn_nonconverged, "m", "f", 2, total=7))


@pytest.mark.parametrize("dtype", [None, np.float32, "float64",
                                   torch.float32])
def test_config_np_dtype_matches_reference(dtype):
    old = tconfig.config.dtype
    try:
        if dtype is not None:
            T.set_default_dtype(dtype)
        want = np.dtype(np.float64 if dtype is None else
                        {np.float32: np.float32, "float64": np.float64,
                         torch.float32: np.float32}[dtype])
        assert tconfig.config.np_dtype == want
        assert isinstance(tconfig.config.np_dtype, np.dtype)
    finally:
        tconfig.config.dtype = old
    assert J.config.np_dtype == tconfig.config.np_dtype


# -- no card and no CPU asked for: the port's own RuntimeError --------------

def _no_card_calls():
    from ngsxfem_tpu_torch.cf.context import EvalCtx
    from ngsxfem_tpu_torch.ops.straightcut import eps_guard
    from ngsxfem_tpu_torch.solvers.dia_cg import dia_cg_fused
    from ngsxfem_tpu_torch.solvers.krylov import cg, jacobi_preconditioner
    from ngsxfem_tpu_torch.solvers.latticemg import _interp_axis
    from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

    v = np.ones(8)
    return {
        "krylov.cg": lambda: cg(lambda z: z, v),
        "jacobi_preconditioner": lambda: jacobi_preconditioner(v),
        "dia_matvec": lambda: dia_matvec([0], v[None], v),
        "dia_cg_fused": lambda: dia_cg_fused([0], v[None], v, v, 2, 4),
        "eps_guard": lambda: eps_guard(v),
        "_interp_axis": lambda: _interp_axis(v, 0),
        "EvalCtx": lambda: EvalCtx(T.MakeStructured2DMesh(nx=1, ny=1),
                                   np.zeros((1, 1, 2))),
        "config.as_input": lambda: tconfig.as_input([1.0, 2.0]),
    }


@pytest.mark.parametrize("name", list(_no_card_calls()))
def test_numpy_without_card_raises(name, monkeypatch):
    """A numpy input with no tensor beside it goes to
    ``resolve_device(None)``, the current card: without one, and without
    the CPU asked for, the call raises the port's ``RuntimeError``, never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _no_card_calls()[name]()


def test_as_input_rules(cpu_default):
    """``config.as_input``: tensors and shims unwrapped as they are, the
    device and floating dtype of ``like``, bool masks kept, numpy's dtype
    without ``like``, an explicit dtype first."""
    x = torch.arange(3.0)
    assert tconfig.as_input(x) is x
    V = T.H1(T.MakeStructured2DMesh(nx=1, ny=1), order=1, **CPU)
    gf = T.GridFunction(V)
    assert tconfig.as_input(gf.vec) is gf.vec.data
    f32 = torch.zeros(2, dtype=torch.float32)
    assert tconfig.as_input(np.ones(2), f32).dtype == torch.float32
    assert tconfig.as_input(np.ones(2, bool), f32).dtype == torch.bool
    assert tconfig.as_input(np.ones(2, np.int32), f32).dtype == torch.float32
    assert tconfig.as_input(np.ones(2), torch.zeros(
        2, dtype=torch.int64)).dtype == torch.float64
    assert tconfig.as_input([1, 2]).dtype == torch.int64
    assert tconfig.as_input(np.ones(2), f32, dtype=np.float64).dtype == \
        torch.float64
    from ngsxfem_tpu_torch.solvers.sparse import SparseMatrix

    mat = SparseMatrix([0], [0], f32[:1], (1, 1), **CPU)
    assert tconfig.as_input(np.ones(1), mat).dtype == torch.float32


# -- chip_smoke.py phase 31 on the CPU ---------------------------------------

def test_chip_smoke_phase_31_on_cpu(monkeypatch, capsys, cpu_default):
    """chip_smoke.py's phase 31 on the CPU at nx=4 (the lattice transfers
    nx 4 -> 8): B1's plain path from numpy with ``plane`` and the Krylov
    functions on the ELL table from numpy, each bitwise the tensor call,
    results on the CPU; CPU tensors launch no kernel, so every count is 0
    here."""
    import time

    import chip_smoke as cs

    monkeypatch.setattr(cs, "P31_LAT_NX", 4)
    monkeypatch.setattr(cs, "P31_REPS", 2)
    monkeypatch.setattr(cs, "IR_INNER", 20)
    dev = torch.device("cpu")
    out = cs.phase_31(dev, *cs.phase_31_system(4, dev), time.perf_counter())
    assert out["dia_cg"] == 0 and out["ell_spmv"] == 0
    assert len(out["cases"]) == 7
    prods = [c["products"] for c in out["cases"] if c["products"]]
    assert prods == [cs.CG_ITERS + 1, cs.CG_ITERS + 1,
                     cs.IR_OUTER * (cs.IR_INNER + 2)]
    text = capsys.readouterr().out
    for tag in ("[31 B1]", "[31 B2]", "[31 no kernel]", "[31 whole]"):
        assert tag in text
