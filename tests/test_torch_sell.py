"""The sliced ELL layout, the card's default ``Inverse()`` and the
fixed-order assembly of the PyTorch port, on the CPU.

``prepare_ell`` (SELL-32-1024) against a numpy construction of its
``slice_ptr``, ``slice_K`` and fill; ``sell_matvec_plain`` (the kernel's
sum) against ``ell_matvec_plain`` under ``torch.equal`` (the two sum the
same slots of each row in the same order; the sliced sum leaves out
trailing padding, which for finite x changes nothing but the sign of an
all-zero row), and both against the JAX package's ``ELLMatrix.matvec`` to
the tolerances of ``test_ell_matvec_plain_matches_reference`` (f64 1e-14,
f32 1e-6).  On the CPU no solver builds a layout (products sum the table
itself); with the card's policy taken (``sparse._on_card`` patched),
``ELLMatrix``, ``CGSolver``, ``MinResSolver`` and ``FunctionalELLMG``
build each layout once and give the unpatched results bit for bit.  The
``Inverse()`` classifier on the examples' matrices, the card's branch on
CPU tensors against the host LU (1e-8), and ``ScatterPlan`` against a
sequential ``index_add_`` (bit for bit).  The kernel itself runs only on a
card: its case skips without one.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import ngsxfem_tpu_torch as T
from ngsxfem_tpu.solvers import sparse as jax_sparse
from ngsxfem_tpu_torch.examples import (cutfem, fictdom3d,
                                        fictdom_dg_ghostpen,
                                        fictdom_dn_ghostpen, fictdom_ghostpen,
                                        nxfem, stokescutfem)
from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
from ngsxfem_tpu_torch.ops.scatter import ScatterPlan
from ngsxfem_tpu_torch.solvers import ell_spmv, krylov, mg, sparse

DT = {"f64": (jnp.float64, torch.float64, 1e-14),
      "f32": (jnp.float32, torch.float32, 1e-6)}


def _table(seed, n, K, ncols, kind="random"):
    """Seeded (vals, cols, x) numpy: trailing padding of a random length in
    each row, rows 3..5 all padding; ``kind`` "nan" puts a NaN in row 1,
    "blocks" alternates long and short rows (as Stokes' velocity and
    pressure rows do)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, ncols, size=(n, K)).astype(np.int32)
    vals = rng.standard_normal((n, K))
    length = rng.integers(0, K + 1, size=n)
    if kind == "blocks":
        length = np.where(np.arange(n) % 7 < 3, K, rng.integers(0, 3, n))
    pad = np.arange(K)[None, :] >= length[:, None]
    pad[3:6] = True
    cols[pad] = 0
    vals[pad] = 0.0
    if kind == "nan" and n > 1 and K:
        vals[1, 0] = np.nan
    return vals, cols, rng.standard_normal(ncols)


def _numpy_layout(vals, cols, window=1024, slice_=32):
    """(slice_ptr, slice_K, fill) of SELL-32-1024 built row by row."""
    n, K = vals.shape
    length = np.zeros(n, np.int64)
    for r in range(n):
        real = np.nonzero((cols[r] != 0) | (vals[r] != 0)
                          | np.isnan(vals[r]))[0]
        length[r] = real[-1] + 1 if real.size else 0
    srt = np.concatenate([-np.sort(-length[w:w + window], kind="stable")
                          for w in range(0, n, window)] or [np.zeros(0, int)])
    ns = -(-n // slice_)
    padded = np.zeros(ns * slice_, np.int64)
    padded[:n] = srt
    sK = padded.reshape(ns, slice_).max(1) if ns else np.zeros(0, np.int64)
    ptr = np.concatenate([[0], np.cumsum(slice_ * sK)])
    return ptr, sK, (length.sum() / ptr[-1] if ptr[-1] else 1.0)


@pytest.mark.parametrize("n,K,kind", [(0, 4, "random"), (1, 1, "random"),
                                      (33, 7, "nan"), (257, 25, "random"),
                                      (2100, 60, "blocks"),
                                      (1100, 64, "random")])
def test_prepare_ell_matches_numpy_construction(n, K, kind):
    vals, cols, _ = _table(1, n, K, n + 3, kind)
    L = ell_spmv.prepare_ell(torch.as_tensor(vals), torch.as_tensor(cols),
                             n + 3)
    ptr, sK, fill = _numpy_layout(vals, cols)
    assert np.array_equal(L.slice_ptr.numpy(), ptr)
    assert np.array_equal(L.slice_K.numpy(), sK)
    assert L.slice_ptr.dtype == torch.int64 and L.slice_K.dtype == torch.int32
    assert L.vals.shape[0] == ptr[-1] and L.fill == pytest.approx(fill)
    assert sorted(L.rows.tolist()) == list(range(n))
    if kind == "blocks":  # the in-window sort fills the slices
        assert L.fill > 0.9 > _numpy_layout(vals, cols, window=1)[2]


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("n,K,kind", [(0, 3, "random"), (1, 1, "random"),
                                      (31, 2, "random"), (33, 16, "nan"),
                                      (97, 25, "random"), (257, 32, "random"),
                                      (300, 60, "blocks"), (129, 64, "random")])
def test_sell_matvec_plain_equals_ell_and_reference(prec, n, K, kind):
    jdt, tdt, tol = DT[prec]
    vals, cols, x = _table(2, n, K, n + 5, kind)
    v, c = torch.as_tensor(vals, dtype=tdt), torch.as_tensor(cols)
    xt = torch.as_tensor(x, dtype=tdt)
    L = ell_spmv.prepare_ell(v, c, n + 5)
    ys = ell_spmv.sell_matvec_plain(L, xt)
    ye = ell_spmv.ell_matvec_plain(v, c, xt)
    assert ys.dtype == tdt and ys.shape == (n,)
    nan = torch.isnan(ye)
    assert torch.equal(torch.isnan(ys), nan) and nan.any() == (kind == "nan")
    assert torch.equal(ys[~nan], ye[~nan])
    yl = ell_spmv.ell_matvec(v, c, xt, L)  # the CPU: the (n, K) sum
    assert torch.equal(torch.isnan(yl), nan) and torch.equal(yl[~nan], ye[~nan])
    A = jax_sparse.ELLMatrix(jnp.asarray(cols), jnp.asarray(vals, dtype=jdt),
                             (n, n + 5))
    yj = np.asarray(A.matvec(jnp.asarray(x, dtype=jdt)))
    ok = ~nan.numpy()
    assert np.array_equal(np.isnan(yj), nan.numpy())
    for y in (ys, ye):
        d = np.linalg.norm(y.numpy()[ok] - yj[ok])
        assert d <= tol * max(np.linalg.norm(yj[ok]), 1e-300)


def test_layout_rejects_another_table():
    vals, cols, x = _table(3, 70, 5, 70)
    v, c, xt = (torch.as_tensor(vals), torch.as_tensor(cols),
                torch.as_tensor(x))
    L = ell_spmv.prepare_ell(v, c)
    for args in ((v[:-1], c[:-1], xt, L), (v.float(), c, xt.float(), L),
                 (v, c, torch.cat([xt, xt]), L)):
        with pytest.raises(ValueError):
            ell_spmv.ell_matvec(*args)


def _poisson_ell(nx=6):
    m = UnfittedPoisson(nx=nx, dim=3, order=1, dtype=torch.float64,
                        device="cpu")
    st = m.ell_structure()
    V, _ = m.assemble_vals_soa1(m.vertices, m.lset, st)
    return m, st, V


def test_solvers_build_each_layout_once(monkeypatch):
    m, st, V = _poisson_ell()
    cols = torch.as_tensor(st["ell_cols"])
    A = sparse.ELLMatrix(cols, V, (m.ndof, m.ndof))
    b = torch.as_tensor(np.where(m.active_dofs, 1.0, 0.0))

    def solves():
        return (krylov.CGSolver(A, maxsteps=40, tol=0.0) * b,
                krylov.CGSolver(A, maxsteps=40, tol=0.0) * b,
                krylov.MinResSolver(A, maxsteps=20, tol=0.0) * b, A @ b)

    built = ell_spmv.layouts_built
    ref = solves()
    assert ell_spmv.layouts_built == built  # the CPU sums the table itself
    assert A.layout() is None
    # products routed as on the card: one layout for the one table
    monkeypatch.setattr(sparse, "_on_card", lambda t: True)
    got = solves()
    assert ell_spmv.layouts_built == built + 1
    assert A.layout() is A.layout() is not None
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_functional_mg_builds_its_layouts_in_prepare(monkeypatch):
    levels = []
    for nx in (4, 8):
        m = UnfittedPoisson(nx=nx, dim=3, order=1, dtype=torch.float64,
                            device="cpu")
        st = m.ell_structure()
        V, _ = m.assemble_vals_soa1(m.vertices, m.lset, st)
        ve = m.lset_np[m.mesh.elements_np]
        cut = (ve < 0).any(1) & (ve > 0).any(1)
        ifm = np.zeros(m.ndof, bool)
        ifm[m.space.el2dof_np[cut].ravel()] = True
        levels.append((m, st, V, ifm & m.active_dofs))
    prols = [mg.prolongation_coo_np(levels[0][0].space, levels[1][0].space)]
    M = mg.FunctionalELLMG([lv[1]["ell_cols"] for lv in levels], prols,
                           if_masks=[None, levels[1][3]], if_iters=4,
                           active_masks=[lv[0].active_dofs for lv in levels])
    params = M.params([lv[2] for lv in levels], dtype=torch.float64,
                      device="cpu")
    b = torch.as_tensor(np.random.default_rng(4).standard_normal(
        levels[1][0].ndof))
    built = ell_spmv.layouts_built
    z = M.apply(M.prepare_host(params), b)
    assert ell_spmv.layouts_built == built  # the CPU sums the tables
    # products routed as on the card: the layouts are built in prepare_host
    monkeypatch.setattr(sparse, "_on_card", lambda t: True)
    pp = M.prepare_host(params)
    assert ell_spmv.layouts_built == built + 5  # 2 levels, R, P, interface
    assert torch.equal(M.apply(pp, b), z)
    assert ell_spmv.layouts_built == built + 5


# the examples' matrices at small sizes: the classifier's answer
SYSTEMS = {
    "fictdom3d": (lambda: fictdom3d.system(nx=4, device="cpu"), "device_cg"),
    "dg": (lambda: fictdom_dg_ghostpen.system(nx=6, order=2, device="cpu"),
           "device_cg"),
    "dn": (lambda: fictdom_dn_ghostpen.system(nx=8, device="cpu"),
           "device_cg"),
    "nxfem": (lambda: nxfem.system(nx=8, device="cpu"), "device_cg"),
    "stokes": (lambda: stokescutfem.system(nx=4, device="cpu"), "host_lu"),
}


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_default_inverse_path_on_the_card(name, monkeypatch):
    """With the card predicate patched, the default Inverse() classifies the
    example's free block and its card branch equals the named LU to 1e-8;
    on the CPU, and for the named methods, it is the host LU."""
    build, path = SYSTEMS[name]
    parts = build()
    a, f, free = parts[0], parts[1], parts[3]
    a.Assemble()
    f.Assemble()
    assert a.mat.Inverse(free).path == "host_lu"
    x_lu = a.mat.Inverse(free, inverse="umfpack") * f.vec
    monkeypatch.setattr(sparse, "_on_card", lambda mat: True)
    inv = a.mat.Inverse(free)
    assert inv.path == path
    assert a.mat.Inverse(free, inverse="sparsecholesky").path == "host_lu"
    x = inv * f.vec
    assert (torch.linalg.vector_norm(x - x_lu)
            <= 1e-8 * torch.linalg.vector_norm(x_lu))


@pytest.mark.parametrize("name", ["fictdom_ghostpen", "cutfem"])
def test_default_inverse_examples_on_the_card_branch(name, monkeypatch):
    """The two examples without a ``system()``: their run() with the card
    branch of the default Inverse() against the host LU's."""
    mod, nx = {"fictdom_ghostpen": (fictdom_ghostpen, 10),
               "cutfem": (cutfem, 8)}[name]
    paths = []
    orig = sparse.InverseMatrix.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        paths.append(self.path)

    e_lu = mod.run(nx=nx, verbose=False, device="cpu")
    monkeypatch.setattr(sparse, "_on_card", lambda mat: True)
    monkeypatch.setattr(sparse.InverseMatrix, "__init__", spy)
    e_cg = mod.run(nx=nx, verbose=False, device="cpu")
    assert paths and set(paths) == {"device_cg"}
    assert abs(e_cg - e_lu) <= 1e-8 * e_lu


def test_default_inverse_raises_when_cg_misses(monkeypatch):
    a, f, _, free, _ = fictdom3d.system(nx=4, device="cpu")
    a.Assemble()
    f.Assemble()
    monkeypatch.setattr(sparse, "_on_card", lambda mat: True)
    monkeypatch.setattr(sparse, "INVERSE_CG_TOL", 0.0)  # out of reach
    with pytest.raises(RuntimeError, match="umfpack"):
        a.mat.Inverse(free) * f.vec


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_scatter_plan_equals_sequential_index_add(dtype):
    """Up to ``CHUNK`` contributions to a slot: the sequential sum, bit for
    bit; more: sequential inside chunks of ``CHUNK``, then over the chunk
    sums in order, with at most ``CHUNK`` passes a level."""
    from ngsxfem_tpu_torch.ops.scatter import CHUNK

    rng = np.random.default_rng(5)
    it = torch.int64 if dtype == torch.float64 else torch.int32
    idx = torch.as_tensor(rng.integers(0, 400, 3000))
    vals = torch.as_tensor(rng.standard_normal(3000), dtype=dtype)
    assert int(torch.bincount(idx).max()) <= CHUNK
    start = torch.as_tensor(rng.standard_normal(400), dtype=dtype)
    seq = start.clone().index_add_(0, idx, vals)  # sequential on the CPU
    plan = ScatterPlan(idx, 400)
    assert len(plan.levels) == 1
    assert torch.equal(plan.add(vals, start.clone()).view(it), seq.view(it))
    # one slot with 5,000 contributions, beside the others
    idx2 = torch.cat([idx, torch.full((5000,), 7)])
    vals2 = torch.cat([vals, torch.as_tensor(rng.standard_normal(5000),
                                             dtype=dtype)])
    plan = ScatterPlan(idx2, 400)
    assert len(plan.levels) == 3
    assert all(len(lv.splits) <= CHUNK for lv in plan.levels)
    ref = torch.zeros(400, dtype=dtype).index_add_(0, idx, vals)
    parts = [v for i, v in zip(idx2.tolist(), vals2) if i == 7]
    for _ in range(2):  # chunk sums, sequential inside each chunk
        parts = [sum(parts[c:c + CHUNK], torch.zeros((), dtype=dtype))
                 for c in range(0, len(parts), CHUNK)]
    ref[7] = sum(parts, torch.zeros((), dtype=dtype))
    assert torch.equal(plan.add(vals2).view(it), ref.view(it))


def test_coo_product_through_a_scatter_plan_on_the_card(monkeypatch):
    """On the card ``SparseMatrix``'s product and diagonal sum through one
    ``ScatterPlan`` of the rows, built once (the branch run here on CPU
    tensors with the card predicate patched): equal to the plan's sums
    bit for bit, to the sequential ``index_add_`` to rounding, and to the
    JAX package's product."""
    a, f, _, free, _ = fictdom3d.system(nx=4, device="cpu")
    a.Assemble()
    A = a.mat
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(A.shape[1]))
    y_seq, d_seq = A * x, A.diagonal()
    monkeypatch.setattr(sparse, "_on_card", lambda mat: True)
    y = A * x
    plan = A._rows_plan
    assert len(plan.levels) > 1  # rows with more than CHUNK triplets
    assert torch.equal(y, plan.add(A.vals * x[A.cols]))
    assert torch.equal(A * x, y) and A._rows_plan is plan
    assert torch.equal(A.diagonal(), plan.add(
        torch.where(A.rows == A.cols, A.vals, 0.0)))
    assert torch.allclose(y, y_seq, rtol=0, atol=1e-13 * float(y.abs().max()))
    assert torch.allclose(A.diagonal(), d_seq, rtol=1e-14, atol=0)
    J = jax_sparse.SparseMatrix(jnp.asarray(A.rows.numpy()),
                                jnp.asarray(A.cols.numpy()),
                                jnp.asarray(A.vals.numpy()), A.shape)
    yj = np.asarray(J.matvec(jnp.asarray(x.numpy())))
    assert np.abs(y.numpy() - yj).max() <= 1e-13 * np.abs(yj).max()


@pytest.mark.cuda
def test_sell_kernel_matches_plain_on_cuda():
    """The kernel on its layout against both plain versions, on the card:
    bit for bit against ``sell_matvec_plain``, ``torch.equal`` against
    ``ell_matvec_plain``, f32 and f64.  Needs a CUDA device and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for dt, it in ((torch.float32, torch.int32), (torch.float64, torch.int64)):
        for n, K, kind in ((1001, 7, "random"), (2100, 60, "blocks"),
                           (65, 25, "random")):
            vals, cols, x = _table(6, n, K, n + 3, kind)
            v = torch.as_tensor(vals, dtype=dt, device="cuda")
            c = torch.as_tensor(cols, device="cuda")
            xt = torch.as_tensor(x, dtype=dt, device="cuda")
            L = ell_spmv.prepare_ell(v, c, n + 3)
            before = ell_spmv.launches
            yk = ell_spmv.ell_matvec(v, c, xt, L)
            assert ell_spmv.launches == before + 1
            ys = ell_spmv.sell_matvec_plain(L, xt)
            ye = ell_spmv.ell_matvec_plain(v, c, xt)
            torch.cuda.synchronize()
            assert torch.equal(yk.view(it), ys.view(it))
            assert torch.equal(yk, ye)


def test_default_inverse_on_cpu_is_the_host_lu():
    a, f, _, free, _ = fictdom3d.system(nx=4, device="cpu")
    a.Assemble()
    assert T.InverseMatrix(a.mat, free).path == "host_lu"
    assert T.InverseMatrix(a.mat, free, "cg").path == "device_cg"


def test_chip_smoke_ell_path_on_cpu(monkeypatch):
    """chip_smoke.py phase 7 on the CPU at nx = 4, 8, 16, its products
    routed as on the card: the MG-CG solve builds one layout per table of
    its cycle, and two more assemblies give the same table bit for bit and
    the same iterations."""
    import chip_smoke as cs
    from ngsxfem_tpu_torch.solvers.dia_cg import dia_cg_fused

    monkeypatch.setattr(cs, "MG_NX", (4, 8, 16))
    monkeypatch.setattr(sparse, "_on_card", lambda t: True)
    dev = torch.device("cpu")
    model, struct, V, _, b, dinv, _ = cs.flagship(16, dev)
    x, _ = dia_cg_fused(struct["offsets"], V, b, dinv, 50)
    ell = cs.ell_path(dev, model, dict(struct, V=V), x)
    assert ell["layouts"] == 9 and ell["iters"] <= cs.MG_MAX_ITERS
    assert cs.repeat_assembly(ell, 2) == [ell["iters"]] * 2


def test_linear_form_keeps_its_scatter_plan(monkeypatch):
    """A second ``Assemble`` of the same dof stream reuses the plan and
    gives the same vector bit for bit."""
    from ngsxfem_tpu_torch.forms import assemble

    made = []
    monkeypatch.setattr(assemble, "ScatterPlan",
                        lambda *a: made.append(1) or ScatterPlan(*a))
    _, f, _, _, _ = fictdom3d.system(nx=4, device="cpu")
    v1 = f.Assemble().vec.data.clone()
    v2 = f.Assemble().vec.data
    assert len(made) == 1 and torch.equal(v1, v2)
