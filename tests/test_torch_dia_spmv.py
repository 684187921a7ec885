"""The DIA product ``dia_spmv.dia_matvec`` (``sparse.dia_matvec``) and its
kernel ``csrc/dia_spmv.cu``.

On the CPU ``dia_matvec`` runs ``dia_matvec_plain`` (counter
``dia_matvec::eager``, never ``::kernel``), keeps autograd for inputs that
require a gradient, and ``dia_spmv.check``, the kernel's input check, raises
``ValueError`` on what the kernel does not take; ``dia_spmv.DiaMatvec``'s
backward (the card's autograd path, its forward the kernel, for which the
plain version stands in on the CPU) passes ``gradcheck`` and
``gradgradcheck``.  The card cases (marked ``cuda``,
skipped without a card) hold the kernel to ``dia_matvec_plain`` bit for bit
in float32 and float64, NaNs equal whatever their payload: the nx=12
lattice table, random tables with offsets beyond n and in no order, up to
32 of them, and vectors (and the random tables) with signed zeros,
infinities and NaNs at the boundary rows; one ``cg_ir`` whose every inner
product, iterate and result is the plain path's; and a product under
autograd, forward and transposed product one launch each, its gradients
those of the plain path.  This file imports no JAX, so the card cases run
where JAX is absent: ``python3 -c "import sys; sys.path.insert(0, 'tests');
import test_torch_dia_spmv as t; t.test_kernel_equals_plain_on_the_card();
t.test_cg_ir_equals_plain_on_the_card();
t.test_autograd_launches_the_kernel_on_the_card()"`` from the repository's
root.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ngsxfem_tpu_torch.solvers import dia_spmv, krylov, sparse
from ngsxfem_tpu_torch.utils import timing


def _bits(t):
    return t.view({torch.float64: torch.int64, torch.float32: torch.int32}[
        t.dtype])


def _same_bits(a, b):
    """The same bits, but that two NaNs are equal whatever their payload."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.cpu(), b.cpu()
    nan = a.isnan()
    return (torch.equal(nan, b.isnan())
            and torch.equal(_bits(a)[~nan], _bits(b)[~nan]))


def _random(offs, n, dtype, device, seed=0):
    """(vals, x) of a random table with the offsets ``offs``, made with
    numpy."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((len(offs), n))
    vals[rng.random(vals.shape) < 0.1] = 0.0
    vals[rng.random(vals.shape) < 0.05] = -0.0
    return (torch.as_tensor(vals, dtype=dtype, device=device),
            torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                            device=device))


def _nan(payload, dtype, device):
    """A quiet NaN of ``dtype`` with the sign and payload bits ``payload``."""
    bits = (np.array([payload], np.uint64).view(np.int64)
            if dtype == torch.float64 else
            np.array([payload & 0xFFFFFFFF], np.uint32).view(np.int32))
    return torch.as_tensor(bits, device=device).view(dtype)[0]


def _specials(x):
    """``x`` with signed zeros, infinities and a NaN at its boundary rows."""
    x = x.clone()
    x[0], x[1], x[2] = -0.0, float("inf"), 0.0
    x[-1], x[-2], x[-3] = float("nan"), -float("inf"), -0.0
    return x


def _special_vals(vals):
    """``vals`` with NaNs of other payloads, infinities and signed zeros at
    the ends of its first and last diagonals."""
    vals = vals.clone()
    big = vals.dtype == torch.float64
    vals[0, 0] = _nan(0x7FF8000000000123 if big else 0x7FC00123,
                      vals.dtype, vals.device)
    vals[-1, -1] = _nan(0xFFF8000000000456 if big else 0xFFC00456,
                        vals.dtype, vals.device)
    vals[0, 1], vals[0, 2] = float("inf"), -0.0
    vals[-1, -2], vals[-1, -3] = -float("inf"), 0.0
    return vals


# (offsets, n): the lattice's 27 in table order, some beyond n in no order,
# and the kernel's most, 32
_TABLES = {
    "lattice27": ([o * 49 + p * 7 + q for o in (-1, 0, 1) for p in (-1, 0, 1)
                   for q in (-1, 0, 1)], 343),
    "beyond_n": ([3000, -1, 0, 999, -2500, 1, 1000, -37, 5], 1000),
    "max32": ([int(o) for o in np.random.default_rng(3).permutation(
        np.arange(-40, 41))[:32]], 300),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("table", sorted(_TABLES))
def test_cpu_runs_plain_and_counts_eager(table, dtype):
    """CPU tensors: ``dia_matvec`` is ``dia_matvec_plain`` bit for bit, the
    span holds one ``dia_matvec::eager`` a call and no ``::kernel``, and
    the kernel's launch count does not move."""
    offs, n = _TABLES[table]
    vals, x = _random(offs, n, dtype, "cpu")
    vals, x = _special_vals(vals), _specials(x)
    before = dia_spmv.launches
    timing.reset_trace()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with timing.Timer("dia", block=False):
                y = sparse.dia_matvec(np.asarray(offs), vals, x)
                y2 = sparse.dia_matvec(offs, vals, x)
        totals, recs = timing.counters(), timing.spans()
    finally:
        timing.reset_trace()
    assert _same_bits(y, sparse.dia_matvec_plain(offs, vals, x))
    assert _same_bits(y2, y)
    assert totals == {"dia_matvec::eager": 2}
    assert [r["counters"] for r in recs] == [totals]
    assert dia_spmv.launches == before


def _bad_inputs():
    """{case: (offsets, vals, x)} that the kernel does not take."""
    offs = [-3, -1, 0, 1, 3]
    v, x = _random(offs, 40, torch.float32, "cpu")
    v64, x64 = v.double(), x.double()
    many = list(range(-16, 17))  # 33 offsets
    vm, xm = _random(many, 40, torch.float32, "cpu")
    return {
        "vals_not_contiguous": (offs, v.t().contiguous().t(), x),
        "vals_column_slice": (offs, torch.cat([v, v], 1)[:, :40], x),
        "33_offsets": (many, vm, xm),
        "no_offsets": ([], v[:0], x),
        "offsets_2d": ([offs], v, x),
        "rows_not_offsets": (offs[:4], v, x),
        "vals_1d": ([0], v[0], x),
        "mixed_dtypes": (offs, v, x64),
        "mixed_dtypes_vals64": (offs, v64, x),
        "float16": (offs, v.half(), x.half()),
        "integer": (offs, v.long(), x.long()),
        "x_too_short": (offs, v, x[:39]),
        "x_not_contiguous": (offs, v, torch.stack([x, x], 1)[:, 0]),
        "x_2d": (offs, v, x[:, None]),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_check_raises_on_what_the_kernel_does_not_take(case):
    """``dia_spmv.check`` (no card needed) raises ``ValueError``."""
    offs, vals, x = _bad_inputs()[case]
    with pytest.raises(ValueError):
        dia_spmv.check(offs, vals, x)


def test_check_gives_the_cached_offsets():
    """A valid input gives the offsets as the kernel's struct, one struct
    per offset tuple whatever container holds it."""
    offs = [5, -1, 0, 1, -5]
    vals, x = _random(offs, 30, torch.float64, "cpu")
    p = dia_spmv.check(offs, vals, x)
    assert p.count == 5 and list(p.off[:5]) == offs
    assert not any(p.off[5:])
    assert dia_spmv.check(np.asarray(offs, np.int32), vals, x) is p
    assert dia_spmv.check(tuple(offs), vals, x) is p
    assert dia_spmv.check(offs[::-1], vals, x) is not p


def test_inputs_that_require_grad_keep_autograd():
    """On the CPU a table and a vector that require a gradient take the
    plain path: d sum(y) / d vals[k, r] = x[r + o_k] (0 off the ends) and
    d sum(y) / d x[c] = sum_k vals[k, c - o_k]."""
    offs = [-4, -1, 0, 2, 9]
    n = 20
    vals, x = _random(offs, n, torch.float64, "cpu", seed=5)
    vals.requires_grad_(True)
    x.requires_grad_(True)
    y = sparse.dia_matvec(offs, vals, x)
    assert y.grad_fn is not None
    y.sum().backward()
    dv = torch.zeros(len(offs), n, dtype=torch.float64)
    dx = torch.zeros(n, dtype=torch.float64)
    for k, o in enumerate(offs):
        for r in range(n):
            if 0 <= r + o < n:
                dv[k, r] = x[r + o].detach()
                dx[r + o] += vals[k, r].detach()
    assert torch.allclose(vals.grad, dv, rtol=0, atol=0)
    assert torch.allclose(x.grad, dx, rtol=1e-15, atol=1e-15)
    with torch.no_grad():
        assert _same_bits(sparse.dia_matvec(offs, vals, x),
                          sparse.dia_matvec_plain(offs, vals.detach(),
                                                  x.detach()))


# small (offsets, n) for gradcheck: in no order, some beyond n
_GRAD_TABLES = {"inside": ([-4, -1, 0, 2, 9], 20),
                "beyond_n": ([25, -1, 0, 7, -30, 3], 20)}


@pytest.mark.parametrize("table", sorted(_GRAD_TABLES))
def test_dia_matvec_function_gradients(table, monkeypatch):
    """``DiaMatvec`` (the card's autograd path; its forward is the kernel,
    for which its plain twin stands in on the CPU): first and second
    derivatives by ``gradcheck`` and ``gradgradcheck``, and its gradients
    those of autograd through ``dia_matvec_plain`` to rounding."""
    monkeypatch.setattr(dia_spmv, "dia_spmv", dia_spmv.dia_matvec_plain)
    offs, n = _GRAD_TABLES[table]
    vals, x = _random(offs, n, torch.float64, "cpu", seed=n + len(offs))
    vals.requires_grad_(True)
    x.requires_grad_(True)

    def f(v, z):
        return dia_spmv.DiaMatvec.apply(v, z, offs)

    assert torch.autograd.gradcheck(f, (vals, x))
    assert torch.autograd.gradgradcheck(f, (vals, x))
    g = torch.as_tensor(np.random.default_rng(7).standard_normal(n))
    got = torch.autograd.grad(f(vals, x), (vals, x), g)
    want = torch.autograd.grad(sparse.dia_matvec_plain(offs, vals, x),
                               (vals, x), g)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-14, atol=1e-14)


def _lattice(dtype, device):
    """The nx=12 lattice table (offsets, V) and its right-hand side."""
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson

    m = UnfittedPoisson(nx=12, dim=3, order=1, dtype=dtype, device=device)
    st = m.dia_structure()
    V, _ = m.assemble_vals_lattice(m.vertices, m.lset, st)
    b = torch.as_tensor(np.where(m.active_dofs[st["perm_inv"]], 1.0, 0.0),
                        dtype=dtype, device=device)
    return st["offsets"], V, b


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card():
    """On the card the kernel gives ``dia_matvec_plain``'s bits (NaNs equal
    whatever their payload), one launch a call, in float32 and float64: on
    the nx=12 lattice table, on the random tables, and with the boundary
    rows' specials."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    rng = np.random.default_rng(12)
    for dtype in (torch.float32, torch.float64):
        offs, V, _ = _lattice(dtype, "cuda")
        assert len(offs) == 27
        x = torch.as_tensor(rng.standard_normal(V.shape[1]), dtype=dtype,
                            device="cuda")
        cases = [("lattice_nx12", offs, V, x),
                 ("lattice_nx12_specials", offs, V, _specials(x))]
        for name, (o, n) in sorted(_TABLES.items()):
            v, xr = _random(o, n, dtype, "cuda", seed=n)
            cases += [(name, o, v, xr),
                      (name + "_specials", o, _special_vals(v),
                       _specials(xr))]
        for name, o, v, xr in cases:
            before = dia_spmv.launches
            y = sparse.dia_matvec(o, v, xr)
            assert dia_spmv.launches == before + 1, name
            torch.cuda.synchronize()
            assert _same_bits(y, sparse.dia_matvec_plain(o, v, xr)), \
                (name, dtype)


@pytest.mark.cuda
def test_cg_ir_equals_plain_on_the_card():
    """``cg_ir(4, 30)`` on the nx=12 lattice table: every float32 and
    float64 product's input and output, the solution and the residual are
    the plain path's bits, and every product is one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    offs, V, b = _lattice(torch.float32, "cuda")
    V64 = V.double()
    k0 = int(np.searchsorted(offs, 0))
    dinv = torch.where(V[k0].abs() > 1e-30, 1.0 / V[k0], 1.0)

    def run(product):
        seen = []

        def mv(A):
            def f(v):
                y = product(offs, A, v)
                seen.append((v, y))
                return y
            return f
        x, res = krylov.cg_ir(mv(V), mv(V64), b, M=lambda r: dinv * r,
                              outer=4, inner=30)
        return seen, x, res

    before = dia_spmv.launches
    seen_k, x_k, res_k = run(sparse.dia_matvec)
    assert dia_spmv.launches == before + len(seen_k) == before + 4 * 31 + 4
    seen_p, x_p, res_p = run(sparse.dia_matvec_plain)
    assert len(seen_k) == len(seen_p)
    for (vk, yk), (vp, yp) in zip(seen_k, seen_p):
        assert _same_bits(vk, vp) and _same_bits(yk, yp)
    assert _same_bits(x_k, x_p) and _same_bits(res_k, res_p)


@pytest.mark.cuda
def test_autograd_launches_the_kernel_on_the_card():
    """A table and a vector on the card that require a gradient: the
    product is one launch and counts ``dia_matvec::kernel``, its backward
    one more launch (the transposed product), and the gradients are those
    of autograd through ``dia_matvec_plain`` to rounding, in float32 and
    float64, on the nx=12 lattice table and the random tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    rng = np.random.default_rng(22)
    for dtype in (torch.float32, torch.float64):
        tol = 1e-5 if dtype == torch.float32 else 1e-13
        offs, V, _ = _lattice(dtype, "cuda")
        cases = [("lattice_nx12", offs, V)]
        for name, (o, n) in sorted(_TABLES.items()):
            cases.append((name, o, _random(o, n, dtype, "cuda", seed=n)[0]))
        for name, o, v in cases:
            n = v.shape[1]
            vals = v.clone().requires_grad_(True)
            x = torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                                device="cuda").requires_grad_(True)
            g = torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                                device="cuda")
            before = dia_spmv.launches
            timing.reset_trace()
            try:
                with profile(activities=[ProfilerActivity.CPU]):
                    with timing.Timer("dia", block=False):
                        y = sparse.dia_matvec(o, vals, x)
                totals = timing.counters()
            finally:
                timing.reset_trace()
            assert totals == {"dia_matvec::kernel": 1}, name
            assert y.grad_fn is not None
            assert dia_spmv.launches == before + 1, name
            got = torch.autograd.grad(y, (vals, x), g)
            assert dia_spmv.launches == before + 2, name
            with torch.no_grad():
                assert _same_bits(y, sparse.dia_matvec_plain(o, vals, x))
            want = torch.autograd.grad(sparse.dia_matvec_plain(o, vals, x),
                                       (vals, x), g)
            for a, b in zip(got, want):
                scale = float(b.abs().max())
                assert float((a - b).abs().max()) <= tol * scale, \
                    (name, dtype)
