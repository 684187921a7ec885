"""Fused Jacobi-PCG of the PyTorch port (solvers/dia_cg.py).

On the CPU the wrapper runs its plain version, held here against the JAX
package's Pallas kernel (interpret mode, as tests/test_pallas_cg.py runs it)
and against the JAX ``krylov.cg`` + ``dia_matvec`` path, at the reference's
thresholds (tests/test_pallas_cg.py:72-89: rel 5e-5, residual 5e-5 ||b||).
The CUDA kernel itself runs only on a card: its test skips without one.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ngsxfem_tpu.solvers import krylov as jax_krylov
from ngsxfem_tpu.solvers import pallas_cg
from ngsxfem_tpu.solvers import sparse as jax_sparse
from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
from ngsxfem_tpu_torch.solvers import dia_cg, krylov, sparse

_CACHE = {}


def _setup(device="cpu"):
    """The port's nx=6 flagship operator (f32), rhs and Jacobi inverse."""
    if device not in _CACHE:
        m = UnfittedPoisson(nx=6, dim=3, order=1, dtype=torch.float32,
                            device=device)
        st = m.dia_structure()
        V, _ = m.assemble_vals_lattice(m.vertices, m.lset, st)
        offs = st["offsets"]
        k0 = int(np.searchsorted(offs, 0))
        b = torch.as_tensor(np.where(m.active_dofs[st["perm_inv"]], 1.0, 0.0),
                            dtype=torch.float32, device=device)
        dinv = torch.where(V[k0].abs() > 1e-30, 1.0 / V[k0], 1.0)
        _CACHE[device] = (offs, V, b, dinv)
    return _CACHE[device]


def _jax(*ts):
    return [jnp.asarray(t.cpu().numpy()) for t in ts]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("iters", [1, 12])
def test_plain_matches_pallas_interpret(iters):
    offs, V, b, dinv = _setup()
    xf, rf = pallas_cg.dia_cg_fused(offs, *_jax(V, b, dinv), iters,
                                    plane=7 * 7, interpret=True)
    xt, rt = dia_cg.dia_cg_fused_plain(offs, V, b, dinv, iters)
    assert _rel(xt.numpy(), xf) < 5e-5
    assert abs(float(rt) - float(rf)) <= 5e-5 * float(torch.linalg.vector_norm(b))


@pytest.mark.parametrize("iters", [1, 12])
def test_plain_matches_reference_cg(iters):
    offs, V, b, dinv = _setup()
    Vj, bj, dj = _jax(V, b, dinv)
    xr, _, rr = jax_krylov.cg(lambda x: jax_sparse.dia_matvec(offs, Vj, x), bj,
                              M=lambda r: dj * r, maxiter=iters, tol=0.0)
    xt, rt = dia_cg.dia_cg_fused_plain(offs, V, b, dinv, iters)
    assert _rel(xt.numpy(), xr) < 5e-5
    assert abs(float(rt) - float(rr)) <= 5e-5 * float(torch.linalg.vector_norm(b))


def test_plain_reduces_residual():
    offs, V, b, dinv = _setup()
    _, rt = dia_cg.dia_cg_fused_plain(offs, V, b, dinv, 40)
    assert float(rt) < 0.05 * float(torch.linalg.vector_norm(b))


def test_sym_matvec_equals_dia_matvec_bitwise():
    """Upper diagonals in table order give dia_matvec's sums exactly."""
    offs, V, _, _ = _setup()
    p = torch.as_tensor(np.random.default_rng(5).standard_normal(V.shape[1]),
                        dtype=torch.float32)
    assert torch.equal(dia_cg._sym_dia_matvec(V, dia_cg._terms(offs), p),
                       sparse.dia_matvec(offs, V, p))


@pytest.mark.parametrize("iters", [0, 1, 12, 50])
def test_wrapper_on_cpu_equals_port_cg_bitwise(iters):
    """On CPU tensors the wrapper runs the plain version (no kernel launch),
    which reproduces the port's krylov.cg + dia_matvec bit for bit — the
    property the CUDA kernel is held to on the card."""
    offs, V, b, dinv = _setup()
    before = dia_cg.launches
    xw, rw = dia_cg.dia_cg_fused(offs, V, b, dinv, iters)
    assert dia_cg.launches == before
    xr, _, rr = krylov.cg(lambda x: sparse.dia_matvec(offs, V, x), b,
                          M=lambda r: dinv * r, maxiter=iters, tol=0.0)
    assert torch.equal(xw, xr) and torch.equal(rw, rr)


def test_rejects_asymmetric_offsets():
    with pytest.raises(ValueError):
        dia_cg._upper([-1, 0, 2])
    _, V, b, dinv = _setup()
    with pytest.raises(ValueError):
        dia_cg.dia_cg_fused([-1, 0, 2], V[:3], b, dinv, 2)


@pytest.mark.parametrize("bad", ["n_off", "b_len", "dinv_dtype",
                                 "noncontig", "iters"])
def test_rejects_bad_inputs(bad):
    offs, V, b, dinv = _setup()
    args = dict(offsets=offs, vals=V, b=b, dinv=dinv, iters=3)
    if bad == "n_off":
        args["vals"] = V[:-1]
    elif bad == "b_len":
        args["b"] = b[:-1]
    elif bad == "dinv_dtype":
        args["dinv"] = dinv.double()
    elif bad == "noncontig":
        args["vals"] = V.t().contiguous().t()
    else:
        args["iters"] = -1
    with pytest.raises(ValueError):
        dia_cg.dia_cg_fused(**args)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """The cooperative CUDA kernel against its plain version, on the card:
    bitwise repeatable and within 5e-4 (the reference's on-hardware bound,
    tests/test_pallas_cg.py:105), on the flagship and on random tables,
    one of them too large for the plan to stage the whole operator; the
    launch plan is the one ``_plan`` makes from the device's limits.  Needs
    a CUDA device and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    info = dia_cg.device_info("cuda")
    assert info["cooperative"] and info["max_threads"] >= dia_cg.THREADS
    cases = [_setup("cuda")]
    for dim, n in ((1, 257), (3, 5003), (3, 1_000_003)):
        cases.append([c.cuda() if torch.is_tensor(c) else c
                      for c in _random_case(dim, n, 7)])
    plan = dia_cg.cuda_plan(cases[-1][0], 1_000_003, "cuda")
    assert plan.staged_terms < 27
    assert plan == dia_cg._plan(1_000_003, cases[-1][0], info["sm_count"],
                                info["smem_bytes"])
    for offs, V, b, dinv in cases:
        for iters in (0, 1, 12, 40):
            before = dia_cg.launches
            xk, rk = dia_cg.dia_cg_fused(offs, V, b, dinv, iters)
            xk2, rk2 = dia_cg.dia_cg_fused(offs, V, b, dinv, iters)
            assert dia_cg.launches == before + 2
            xp, rp = dia_cg.dia_cg_fused_plain(offs, V, b, dinv, iters)
            torch.cuda.synchronize()
            assert torch.equal(xk, xk2) and torch.equal(rk, rk2)
            assert _rel(xk.cpu().numpy(), xp.cpu().numpy()) <= 5e-4
            assert abs(float(rk) - float(rp)) <= 5e-4 * float(
                torch.linalg.vector_norm(b))


# --- the cooperative kernel's launch plan and its contract on random tables


def _flagship_offsets(dim, nx):
    """The DIA offsets of the P1 flagship (element and ghost-penalty
    couplings) on an nx mesh, w = nx + 1 vertices per row."""
    w = nx + 1
    if dim == 2:
        pos = [1, w - 1, w, w + 1, w + 2, 2 * w + 1]
    else:
        pos = [1, w - 1, w, w + 1, w * w - w, w * w - 1, w * w, w * w + 1,
               w * w + w, w * w + w + 1, w * w + w + 2, w * w + 2 * w + 1,
               2 * w * w + w + 1]
    return np.array(sorted([-o for o in pos] + [0] + pos))


@pytest.mark.parametrize("dim,nx", [(2, 4), (2, 6), (3, 4), (3, 6)])
def test_flagship_offsets_formula(dim, nx):
    m = UnfittedPoisson(nx=nx, dim=dim, order=1, dtype=torch.float32,
                        device="cpu")
    assert np.array_equal(m.dia_structure()["offsets"],
                          _flagship_offsets(dim, nx))


# H100: 132 SMs, 232,448 B opt-in shared memory per block less the kernel's
# static shared memory; then fewer SMs and smaller limits
_LIMITS = [(132, 232448 - 524), (114, 232448 - 524), (16, 101376),
           (132, 48 * 1024)]


@pytest.mark.parametrize("sm_count,smem", _LIMITS)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n", [1, 257, 117_649, 274_625, 2_146_689])
def test_plan_covers_rows_and_windows(n, dim, sm_count, smem):
    nx = round(n ** (1 / dim)) - 1 if n > 1 else 1
    offs = _flagship_offsets(dim, nx)
    plan = dia_cg._plan(n, offs, sm_count, smem)
    assert 1 <= plan.grid <= sm_count and plan.threads == dia_cg.THREADS
    assert plan.o_max == max(abs(int(o)) for o in offs)
    # every row exactly once, every block non-empty
    rows = [plan.rows(j, n) for j in range(plan.grid)]
    assert rows[0][0] == 0 and rows[-1][1] == n
    assert all(s < e for s, e in rows)
    assert all(rows[j][1] == rows[j + 1][0] for j in range(plan.grid - 1))
    # within the shared-memory limit, and the bytes are what is staged
    assert plan.smem <= smem
    assert plan.smem == 4 * ((4 * plan.chunk if plan.stage_vec else 0)
                             + plan.staged_terms * plan.chunk + plan.win)
    assert sorted(sl for sl in plan.slots if sl >= 0) == list(
        range(plan.staged_terms))
    # the staged window holds the block's rows and its halo, within [0, n);
    # with the whole halo staged it covers every column the rows read
    full = plan.halo == min(plan.o_max, n)
    if plan.win:
        assert plan.win == plan.chunk + 2 * plan.halo
    else:
        assert 4 * plan.chunk > smem
    for j, (s, e) in enumerate(rows):
        lo, hi = plan.window(j, n)
        if not plan.win:
            assert lo == hi
            continue
        assert lo <= s < e <= hi and hi - lo <= plan.win
        assert (lo, hi) == (max(0, s - plan.halo), min(n, e + plan.halo))
        if full:
            assert (lo, hi) == (max(0, s - plan.o_max), min(n, e + plan.o_max))
    # a part of the operator is left out only when it does not fit
    if not full and plan.win:
        assert 4 * (plan.chunk + 2 * (plan.halo + 1)) > smem
    if plan.staged_terms < len(offs):
        assert plan.smem + 4 * plan.chunk > smem


@pytest.mark.parametrize("nx,staged,full_window", [(48, 27, True),
                                                   (64, 14, True),
                                                   (128, 0, False)])
def test_plan_on_the_h100(nx, staged, full_window):
    """nx=48 stages the whole operator, nx=64 part of the coefficients,
    nx=128 only part of the p window; every one of them launches."""
    n = (nx + 1) ** 3
    plan = dia_cg._plan(n, _flagship_offsets(3, nx), *_LIMITS[0])
    assert plan.staged_terms == staged
    assert (plan.halo == plan.o_max) == full_window
    assert plan.full == (staged == 27 and full_window)
    assert plan.barriers_per_iter == 2 and plan.grid <= 132
    assert str(plan.grid) in plan.describe()


def test_plan_rejects():
    with pytest.raises(ValueError):
        dia_cg._plan(0, [0], 132, 100_000)
    with pytest.raises(ValueError):  # 33 offsets
        dia_cg._plan(100, np.arange(-16, 17), 132, 100_000)
    with pytest.raises(ValueError):
        dia_cg._plan(100, [-1, 0, 2], 132, 100_000)


def _random_case(dim, n, seed):
    from chip_smoke import lattice_offsets, random_dia

    offs = lattice_offsets(dim, max(2, round(n ** (1 / dim))))
    V, b, dinv = random_dia(np.random.default_rng(seed), n, offs, "cpu")
    return offs, V, b, dinv


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 257, 5003])
def test_plain_on_random_tables_equals_port_cg_bitwise(dim, n):
    """The kernel's contract on seeded random exactly symmetric tables:
    dia_cg_fused_plain == the port's krylov.cg + dia_matvec bit for bit."""
    offs, V, b, dinv = _random_case(dim, n, 10 * dim + n)
    for iters in (0, 1, 12, 50):
        xw, rw = dia_cg.dia_cg_fused(offs, V, b, dinv, iters)
        xr, _, rr = krylov.cg(lambda x: sparse.dia_matvec(offs, V, x), b,
                              M=lambda r: dinv * r, maxiter=iters, tol=0.0)
        assert torch.equal(xw, xr) and torch.equal(rw, rr)


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 257, 5003])
def test_plain_on_random_tables_matches_reference_cg(dim, n):
    offs, V, b, dinv = _random_case(dim, n, 10 * dim + n)
    Vj, bj, dj = _jax(V, b, dinv)
    for iters in (1, 12):
        xr, _, rr = jax_krylov.cg(lambda x: jax_sparse.dia_matvec(offs, Vj, x),
                                  bj, M=lambda r: dj * r, maxiter=iters,
                                  tol=0.0)
        xt, rt = dia_cg.dia_cg_fused_plain(offs, V, b, dinv, iters)
        assert _rel(xt.numpy(), xr) < 5e-5
        assert abs(float(rt) - float(rr)) <= 5e-5 * float(
            torch.linalg.vector_norm(b))
