"""Differentiable unfitted FEM in the PyTorch port against ``jax.grad``.

The same inputs, made with numpy, go through the JAX package and the port
(CPU, f64):

- kernel B2's autograd Function ``EllMatvec`` against ``jax.vjp`` of the JAX
  ``ELLMatrix.matvec`` (1e-13 relative), on a symmetric and a non-symmetric
  table, and the raw ``ell_matvec`` under autograd;
- the flagship compliance b^T x of ``tests/test_ad_fastpath.py`` (lattice
  assembly + DIA operator + unrolled Jacobi-PCG, and the one-pass ELL
  assembly + ELL products + the same PCG) at NX=8 against ``jax.grad`` of
  the JAX package's two functions (1e-10 relative) and the port's own
  central difference (1e-5), the two paths against each other (1e-6), as
  that test holds them; r0 lies midway between two vertex distances, so
  the difference and the gradient see one sign pattern and no tie of a
  ``clamp`` or ``eps_guard`` is met;
- the NEG-volume gradient against 4 pi r^2 (0.06);
- ``examples.levelset_shape_opt``: the area gradient against ``jax.grad``
  (1e-12), ``run``, and ``compliance_sensitivity`` through
  ``krylov.cg_implicit`` against ``jax.grad`` (1e-9) and a central
  difference (1e-7);
- ``cg_implicit`` against the unrolled ``cg`` at convergence (1e-9);
- the repairs: ``dia_cg_fused`` refuses an input that requires a gradient,
  and ``ELLMatrix.matvec`` reaches the autograd Function on the card's
  branch (``sparse._on_card`` patched) instead of a detached product.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ngsxfem_tpu.models.poisson import UnfittedPoisson as JUnfittedPoisson
from ngsxfem_tpu.solvers.krylov import cg as jcg
from ngsxfem_tpu.solvers.sparse import ELLMatrix as JELLMatrix
from ngsxfem_tpu.solvers.sparse import dia_matvec as jdia_matvec

from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
from ngsxfem_tpu_torch.solvers import dia_cg, ell_spmv, sparse
from ngsxfem_tpu_torch.solvers.krylov import cg, cg_implicit
from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix, dia_matvec

NX = 8
CG_ITERS = 80
F64 = torch.float64


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _random_ell(rng, n, K, ncols, symmetric):
    """An (n, K) ELL table with padding slots (col 0, value 0) at the end of
    every row; symmetric: the ELL form of a seeded symmetric matrix."""
    if symmetric:
        A = np.zeros((n, n))
        for r in range(n):
            nb = rng.choice(n, size=K // 2, replace=False)
            A[r, nb] = rng.standard_normal(K // 2)
        A = A + A.T + np.diag(rng.uniform(1, 2, n))
        rows = [np.nonzero(A[r])[0] for r in range(n)]
        K = max(len(c) for c in rows) + 1
        cols = np.zeros((n, K), np.int32)
        vals = np.zeros((n, K))
        for r, c in enumerate(rows):
            cols[r, :len(c)] = c
            vals[r, :len(c)] = A[r, c]
        return cols, vals
    cols = rng.integers(0, ncols, size=(n, K)).astype(np.int32)
    vals = rng.standard_normal((n, K))
    length = rng.integers(0, K + 1, size=n)
    pad = np.arange(K)[None, :] >= length[:, None]
    cols[pad] = 0
    vals[pad] = 0.0
    return cols, vals


@pytest.mark.parametrize("symmetric", [True, False])
def test_ell_matvec_vjp_matches_jax(symmetric):
    rng = np.random.default_rng(7 + symmetric)
    n, ncols = 300, (300 if symmetric else 211)
    cols, vals = _random_ell(rng, n, 9, ncols, symmetric)
    ncols = n if symmetric else ncols
    x = rng.standard_normal(ncols)
    g = rng.standard_normal(n)
    JA = JELLMatrix(jnp.asarray(cols), jnp.asarray(vals), (n, ncols))
    y_j, vjp = jax.vjp(lambda v, xx: JELLMatrix(JA.cols, v, JA.shape)
                       .matvec(xx), jnp.asarray(vals), jnp.asarray(x))
    gv_j, gx_j = (np.asarray(t) for t in vjp(jnp.asarray(g)))

    tv = torch.tensor(vals, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    A = ELLMatrix(torch.as_tensor(cols), tv, (n, ncols))
    y = A.matvec(tx)
    assert type(y.grad_fn).__name__ == "EllMatvecBackward"
    y.backward(torch.as_tensor(g))
    for got, want in ((y.detach(), y_j), (tv.grad, gv_j), (tx.grad, gx_j)):
        err = np.abs(got.numpy() - np.asarray(want)).max()
        assert err <= 1e-13 * np.abs(np.asarray(want)).max(), err
    # the raw product builds its transposed table in the backward
    tv.grad = tx.grad = None
    ell_spmv.ell_matvec(tv, A.cols, tx).backward(torch.as_tensor(g))
    assert np.abs(tx.grad.numpy() - gx_j).max() <= 1e-13 * np.abs(gx_j).max()
    assert np.abs(tv.grad.numpy() - gv_j).max() <= 1e-13 * np.abs(gv_j).max()
    # the transposed table is the transpose, padding left out
    vt, ct = ell_spmv.transpose_ell(tv.detach(), A.cols, ncols)
    dense = np.zeros((n, ncols))
    np.add.at(dense, (np.repeat(np.arange(n), cols.shape[1]), cols.ravel()),
              vals.ravel())
    dense_t = np.zeros((ncols, n))
    np.add.at(dense_t, (np.repeat(np.arange(ncols), vt.shape[1]),
                        ct.numpy().ravel()), vt.numpy().ravel())
    assert np.array_equal(dense_t, dense.T)


def test_matvec_on_card_branch_reaches_the_function(monkeypatch):
    """With the card's branch taken (a layout per table), a table that
    requires a gradient still goes through ``EllMatvec``: the product keeps
    its graph, and the backward's transposed table is built once and
    kept beside the forward layout."""
    monkeypatch.setattr(sparse, "_on_card", lambda t: True)
    rng = np.random.default_rng(3)
    cols, vals = _random_ell(rng, 64, 6, 50, False)
    tv = torch.tensor(vals, requires_grad=True)
    A = ELLMatrix(torch.as_tensor(cols), tv, (64, 50))
    x = torch.tensor(rng.standard_normal(50))
    for _ in range(2):
        y = A.matvec(x.clone().requires_grad_())
        assert type(y.grad_fn).__name__ == "EllMatvecBackward"
        y.sum().backward()
    assert A.layout() is not None and A.transposed().layout() is not None
    assert A._transposed[2] is A.transposed()  # kept, not rebuilt
    with torch.no_grad():
        assert A.matvec(x).grad_fn is None


def test_dia_cg_fused_refuses_grad():
    offs = [-1, 0, 1]
    n = 8
    V = torch.zeros(3, n, dtype=F64)
    V[1] = 2.0
    V[0, 1:] = -1.0
    V[2, :-1] = -1.0
    b = torch.ones(n, dtype=F64, requires_grad=True)
    dinv = torch.full((n,), 0.5, dtype=F64)
    with pytest.raises(RuntimeError, match="no backward"):
        dia_cg.dia_cg_fused(offs, V, b, dinv, 5)
    with torch.no_grad():
        x, _ = dia_cg.dia_cg_fused(offs, V, b, dinv, 5)
    x2, _ = dia_cg.dia_cg_fused(offs, V, b.detach(), dinv, 5)
    assert torch.equal(x, x2)


# --- the flagship compliance of tests/test_ad_fastpath.py ------------------


@pytest.fixture(scope="module")
def flagship():
    jm = JUnfittedPoisson(nx=NX, dim=3, order=1, dtype=jnp.float64)
    tm = UnfittedPoisson(nx=NX, dim=3, order=1, dtype=F64, device="cpu")
    vd = np.sqrt(((jm.mesh.vertices_np - 0.5) ** 2).sum(1))
    vds = np.unique(vd)
    i = int(np.searchsorted(vds, 0.4))
    r0 = float(0.5 * (vds[i - 1] + vds[i]))
    return jm, tm, vd, r0


def _jax_compliances(jm, vd):
    dst = jm.dia_structure()
    dd = {k: (jnp.asarray(v) if "slots" in k else v) for k, v in dst.items()}
    offs = dst["offsets"]
    k0 = int(np.searchsorted(np.asarray(offs), 0))
    jvd = jnp.asarray(vd)
    b_dia = jnp.asarray(np.where(jm.active_dofs[dst["perm_inv"]], 1.0, 0.0))
    b_dof = jnp.asarray(np.where(jm.active_dofs, 1.0, 0.0))

    def lattice(r):
        V, _ = jm.assemble_vals_lattice(jm.vertices, jvd - r, dd)
        dinv = jnp.where(jnp.abs(V[k0]) > 1e-30, 1.0 / V[k0], 1.0)
        x, _, _ = jcg(lambda z: jdia_matvec(offs, V, z), b_dia,
                      M=lambda w: dinv * w, maxiter=CG_ITERS, tol=0.0)
        return jnp.vdot(b_dia, x)

    st = jm.ell_structure()
    lv = jm.lset_np[jm.mesh.elements_np]
    cap = int(((lv < 0).any(1) & (lv > 0).any(1)).sum()) + 16
    std = {k: (jnp.asarray(v) if k != "K" else v) for k, v in st.items()}
    cols = jnp.asarray(st["ell_cols"])
    rid = jnp.arange(cols.shape[0])[:, None]

    def general(r):
        vals, _ = jm.assemble_ell_vals(jm.vertices, jvd - r, cap, std)
        d = jnp.sum(jnp.where(cols == rid, vals, 0.0), axis=1)
        dinv = jnp.where(jnp.abs(d) > 1e-30, 1.0 / d, 1.0)
        x, _, _ = jcg(lambda z: jnp.sum(vals * z[cols], axis=1), b_dof,
                      M=lambda w: dinv * w, maxiter=CG_ITERS, tol=0.0)
        return jnp.vdot(b_dof, x)

    return lattice, general


def _port_compliances(tm, vd):
    """The same two functions in the port: lattice assembly + DIA operator
    + unrolled ``krylov.cg``, and ``assemble_vals_soa1`` + ``ELLMatrix``
    products (``EllMatvec`` under autograd) + the same PCG."""
    dst = tm.dia_structure()
    offs = dst["offsets"]
    k0 = int(np.searchsorted(offs, 0))
    tvd = torch.as_tensor(vd)
    b_dia = torch.as_tensor(np.where(tm.active_dofs[dst["perm_inv"]], 1.0,
                                     0.0))
    b_dof = torch.as_tensor(np.where(tm.active_dofs, 1.0, 0.0))
    st = tm.ell_structure()
    cols = torch.as_tensor(st["ell_cols"])

    def lattice(r):
        V, _ = tm.assemble_vals_lattice(tm.vertices, tvd - r, dst)
        dinv = torch.where(V[k0].abs() > 1e-30, 1.0 / V[k0], 1.0)
        x, _, _ = cg(lambda z: dia_matvec(offs, V, z), b_dia,
                     M=lambda w: dinv * w, maxiter=CG_ITERS, tol=0.0)
        return torch.dot(b_dia, x)

    def general(r):
        vals, _ = tm.assemble_vals_soa1(tm.vertices, tvd - r, st)
        A = ELLMatrix(cols, vals, (tm.ndof, tm.ndof))
        d = A.diagonal()
        dinv = torch.where(d.abs() > 1e-30, 1.0 / d, 1.0)
        x, _, _ = cg(A.matvec, b_dof, M=lambda w: dinv * w,
                     maxiter=CG_ITERS, tol=0.0)
        return torch.dot(b_dof, x)

    return lattice, general


def _value_and_grad(fn, r0):
    r = torch.tensor(r0, dtype=F64, requires_grad=True)
    J = fn(r)
    (g,) = torch.autograd.grad(J, r)
    return float(J.detach()), float(g)


def test_compliance_gradients_match_jax_and_fd(flagship):
    jm, tm, vd, r0 = flagship
    j_lat, j_gen = _jax_compliances(jm, vd)
    t_lat, t_gen = _port_compliances(tm, vd)
    grads = {}
    # jit compiles the general path's gradient in seconds; the lattice
    # path's unrolled program takes minutes to compile, so it runs eagerly
    for name, jf, tf in (("lattice", jax.value_and_grad(j_lat), t_lat),
                         ("general", jax.jit(jax.value_and_grad(j_gen)),
                          t_gen)):
        jv, jg = (float(t) for t in jf(r0))
        tv, tg = _value_and_grad(tf, r0)
        assert tg != 0.0, f"{name}: the gradient died"
        assert _rel(tv, jv) < 1e-10, (name, tv, jv)
        assert _rel(tg, jg) < 1e-10, (name, tg, jg)
        grads[name] = tg
    eps = 1e-6
    with torch.no_grad():
        fd = (float(t_lat(r0 + eps)) - float(t_lat(r0 - eps))) / (2 * eps)
    assert _rel(grads["lattice"], fd) < 1e-5, (grads["lattice"], fd)
    assert _rel(grads["lattice"], grads["general"]) < 1e-6, grads


def test_assembly_values_unchanged_under_autograd(flagship):
    """The assemblies under autograd give the same table, bit for bit, as
    without it: the gradients differentiate the very values the forward
    returns."""
    _, tm, vd, r0 = flagship
    dst, st = tm.dia_structure(), tm.ell_structure()
    for fn, s in ((tm.assemble_vals_lattice, dst),
                  (tm.assemble_vals_soa1, st)):
        r = torch.tensor(r0, dtype=F64, requires_grad=True)
        V, _ = fn(tm.vertices, torch.as_tensor(vd) - r, s)
        with torch.no_grad():
            V0, _ = fn(tm.vertices, torch.as_tensor(vd) - r0, s)
        assert V.requires_grad and torch.equal(V.detach(), V0)


def test_volume_gradient_analytic(flagship):
    """d(NEG volume)/dr through the port's tet cut rule against the
    surface area 4 pi r^2 (tests/test_ad_fastpath.py's bound)."""
    from ngsxfem_tpu_torch.mesh.mesh import det_and_inv, map_points
    from ngsxfem_tpu_torch.ops.straightcut import cut_rule_element, eps_guard

    _, tm, vd, r0 = flagship
    els = torch.as_tensor(tm.mesh.elements_np, dtype=torch.int64)
    c3 = torch.as_tensor(tm.mesh.vertices_np)[els]
    r = torch.tensor(r0, dtype=F64, requires_grad=True)
    rule = cut_rule_element("tet", eps_guard((torch.as_tensor(vd) - r)[els]),
                            2)
    _, J = map_points("tet", c3, rule.pts)
    detJ, _ = det_and_inv(J)
    vol = torch.sum(rule.w * (rule.side == 0) * detJ.abs())
    (dv,) = torch.autograd.grad(vol, r)
    assert abs(float(dv) - 4 * np.pi * r0 ** 2) < 0.06, float(dv)


# --- examples/levelset_shape_opt.py ----------------------------------------


def test_levelset_shape_opt_matches_jax():
    import examples.levelset_shape_opt as jex
    from ngsxfem_tpu_torch.examples import levelset_shape_opt as tex

    r0 = 0.31
    g_j = float(jax.grad(jex.make_area_fn(nx=32))(r0))
    area = tex.make_area_fn(nx=32, device="cpu")
    r = torch.tensor(r0, dtype=F64, requires_grad=True)
    (g_t,) = torch.autograd.grad(area(r), r)
    assert _rel(float(g_t), g_j) < 1e-12, (float(g_t), g_j)
    assert abs(float(g_t) - 2 * np.pi * r0) < 0.02

    r_opt, final = tex.run(nx=32, target_area=0.25, verbose=False,
                           device="cpu")
    assert abs(final - 0.25) < 1e-10
    assert abs(r_opt - np.sqrt(0.25 / np.pi)) < 2e-3
    assert abs(r_opt - jex.run(nx=32, target_area=0.25, verbose=False)[0]) \
        < 1e-12

    c_j, dc_j = (float(t) for t in jax.jit(jax.value_and_grad(
        jex.compliance_sensitivity(nx=10)))(0.33))
    comp_t = tex.compliance_sensitivity(nx=10, device="cpu")
    r = torch.tensor(0.33, dtype=F64, requires_grad=True)
    c = comp_t(r)
    (dc_t,) = torch.autograd.grad(c, r)
    assert _rel(float(c.detach()), c_j) < 1e-10
    assert _rel(float(dc_t), dc_j) < 1e-9, (float(dc_t), dc_j)
    eps = 1e-5
    fd = (float(comp_t(0.33 + eps)) - float(comp_t(0.33 - eps))) / (2 * eps)
    assert _rel(float(dc_t), fd) < 1e-7, (float(dc_t), fd)


# --- the implicitly differentiated CG ----------------------------------------


def test_cg_implicit_matches_unrolled_cg():
    """J = b^T A(p)^-1 b for an SPD ELL table A(p) = A0 + diag(p): the
    gradient through ``cg_implicit`` (in p and in b) against the gradient
    of the unrolled ``cg`` run to convergence."""
    rng = np.random.default_rng(11)
    n = 40
    cols, vals = _random_ell(rng, n, 6, n, True)
    vals = np.where(cols == np.arange(n)[:, None], 0.0, 0.1 * vals)
    diag = np.zeros_like(vals)
    for r in range(n):  # every row of the symmetric table holds its diagonal
        k = np.nonzero(cols[r] == r)[0]
        diag[r, k[0] if len(k) else 0] = 1.0 if len(k) else 0.0
    assert (diag.sum(1) == 1).all()
    tcols = torch.as_tensor(cols)
    b0 = rng.standard_normal(n)
    p0 = rng.uniform(2.0, 3.0, n)
    out = []
    for implicit in (True, False):
        p = torch.tensor(p0, requires_grad=True)
        b = torch.tensor(b0, requires_grad=True)
        tv = torch.as_tensor(vals) + torch.as_tensor(diag) * p[:, None]
        A = ELLMatrix(tcols, tv, (n, n))
        if implicit:
            x = cg_implicit(A, b, (tv,), tol=1e-14, maxiter=10 * n)
        else:
            x, _, _ = cg(lambda v: A.matvec(v), b, maxiter=3 * n, tol=0.0)
        J = torch.dot(b, x)
        out.append((float(J), *torch.autograd.grad(J, (p, b))))
    (j1, gp1, gb1), (j2, gp2, gb2) = out
    assert _rel(j1, j2) < 1e-12
    for g1, g2 in ((gp1, gp2), (gb1, gb2)):
        assert float((g1 - g2).abs().max() / g2.abs().max()) < 1e-9
    # an unconverged implicit solve raises instead of returning a guess
    with pytest.raises(RuntimeError, match="cg_implicit"):
        cg_implicit(A, b.detach(), (), tol=1e-14, maxiter=2)


def test_cg_implicit_refuses_values_changed_in_place():
    """``cg_implicit`` keeps its params for the backward through
    ``save_for_backward``: values changed in place between forward and
    backward raise instead of giving a wrong gradient."""
    rng = np.random.default_rng(12)
    n = 30
    a = rng.standard_normal((n, n))
    cols = torch.as_tensor(np.tile(np.arange(n, dtype=np.int32), (n, 1)))
    tv = torch.tensor(a @ a.T + n * np.eye(n), requires_grad=True)
    vals = tv * 1.0
    b = torch.as_tensor(rng.standard_normal(n))
    x = cg_implicit(ELLMatrix(cols, vals, (n, n)), b, (vals,), tol=1e-14,
                    maxiter=10 * n)
    with torch.no_grad():
        vals.mul_(2.0)
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        torch.dot(b, x).backward()
