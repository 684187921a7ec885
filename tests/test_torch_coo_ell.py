"""The ELL table of a ``SparseMatrix`` built where its triplets lie
(``solvers/coo_ell.py``), the one ``to_ell`` on every device.

On the CPU ``coo_to_ell`` runs its plain version (``place_plain``); it and
``SparseMatrix.to_ell`` must each give the table of the JAX package's
``SparseMatrix.to_ell`` bit for bit: equal columns and equal bits of the
values, on streams with long runs of duplicates, empty rows, a rectangular
shape, float32 values (summed in f64, rounded once), no triplet at all, and
``a.mat`` of the fictdom3d forms.  A row outside the matrix raises through
both calls, and so do values that require grad.  The card case (marked
``cuda``, skipped without a card) holds the kernel ``csrc/coo_ell.cu`` to
the plain version and to the CPU's table on the nx=24 forms matrix, and the
Jacobi-CG solve through both tables.  This file imports no
JAX at top level, so the card case runs where JAX is absent:
``python3 -c "import sys; sys.path.insert(0, 'tests'); import
test_torch_coo_ell as t; t.test_kernel_equals_plain_and_host_on_the_card()"``
from the repository's root.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ngsxfem_tpu_torch.config import as_input
from ngsxfem_tpu_torch.examples import fictdom3d
from ngsxfem_tpu_torch.solvers import coo_ell, krylov, sparse
from ngsxfem_tpu_torch.utils import timing


def _bits(t):
    return t.view({torch.float64: torch.int64, torch.float32: torch.int32}[
        t.dtype])


def _same_table(c1, v1, c2, v2):
    return (c1.shape == c2.shape and c1.dtype == c2.dtype == torch.int32
            and v1.dtype == v2.dtype and torch.equal(c1.cpu(), c2.cpu())
            and torch.equal(_bits(v1.cpu()), _bits(v2.cpu())))


def _stream(case):
    """(rows, cols, vals, shape) of one case, made with numpy."""
    rng = np.random.default_rng(20)
    if case == "coo":
        from test_torch_ell import _coo  # imports JAX: CPU only

        return _coo()
    if case == "repeat200":  # one entry 200 times amid others
        rows = np.r_[np.full(200, 3), rng.integers(0, 12, 300)]
        cols = np.r_[np.full(200, 4), rng.integers(0, 10, 300)]
        p = rng.permutation(500)
        return rows[p], cols[p], 1e3 * rng.standard_normal(500), (12, 10)
    if case == "empty_rows":  # rows 0, 10, 20, ... only
        rows = 10 * rng.integers(0, 5, 400)
        return rows, rng.integers(0, 50, 400), rng.standard_normal(400), \
            (50, 50)
    if case == "rectangular":
        return (rng.integers(0, 30, 900), rng.integers(0, 70, 900),
                rng.standard_normal(900), (30, 70))
    if case == "float32":
        return (rng.integers(0, 40, 2000), rng.integers(0, 40, 2000),
                rng.standard_normal(2000).astype(np.float32), (40, 40))
    if case == "empty":
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0),
                (7, 7))
    assert case == "fictdom3d_nx6"
    a = fictdom3d.system(nx=6, device="cpu")[0]
    a.Assemble()
    m = a.mat
    return m.rows.numpy(), m.cols.numpy(), m.vals.numpy(), m.shape


def _jax_table(rows, cols, vals, shape):
    """(cols, vals) of the JAX package's ``SparseMatrix.to_ell`` as torch
    tensors (imports JAX: CPU only)."""
    import jax.numpy as jnp
    from ngsxfem_tpu.solvers import sparse as jax_sparse

    E = jax_sparse.SparseMatrix(rows, cols, jnp.asarray(vals), shape).to_ell()
    return (torch.from_numpy(np.array(E.cols)),
            torch.from_numpy(np.array(E.vals)))


@pytest.mark.parametrize("case", ["coo", "repeat200", "empty_rows",
                                  "rectangular", "float32", "empty",
                                  "fictdom3d_nx6"])
def test_plain_equals_host_conversion(case):
    """``coo_to_ell`` and ``SparseMatrix.to_ell`` on the CPU (its plain
    version) each give the JAX package's table bit for bit."""
    rows, cols, vals, shape = _stream(case)
    jc, jv = _jax_table(rows, cols, vals, shape)
    S = sparse.SparseMatrix(rows, cols, vals, shape, device="cpu")
    host = S.to_ell()
    assert _same_table(host.cols, host.vals, jc, jv)
    c, v, nu = coo_ell.coo_to_ell(S.rows, S.cols, S.vals, S.shape)
    assert _same_table(c, v, jc, jv)
    assert nu == len(set(zip(np.asarray(rows).tolist(),
                             np.asarray(cols).tolist())))
    assert host.shape == tuple(shape)


@pytest.mark.parametrize("row", [-1, 12])
def test_row_outside_the_matrix_raises_as_on_the_host(row):
    """A row below 0 or from n on: ``SparseMatrix.to_ell`` and
    ``coo_to_ell`` raise ``ValueError``."""
    error = ValueError
    rows, cols, vals, shape = _stream("repeat200")
    rows = rows.copy()
    rows[17] = row
    with pytest.raises(error):
        sparse.SparseMatrix(rows, cols, vals, shape, device="cpu").to_ell()
    with pytest.raises(error):
        coo_ell.coo_to_ell(torch.as_tensor(rows), torch.as_tensor(cols),
                           torch.as_tensor(vals), shape)


def test_values_that_require_grad_raise():
    """The table has no gradient: values that require one raise through
    ``SparseMatrix.to_ell`` and ``coo_to_ell``."""
    rows, cols, vals, shape = _stream("rectangular")
    S = sparse.SparseMatrix(rows, cols, vals, shape, device="cpu")
    S.vals.requires_grad_(True)
    with pytest.raises(RuntimeError):
        S.to_ell()
    with pytest.raises(RuntimeError):
        coo_ell.coo_to_ell(S.rows, S.cols, S.vals, S.shape)


def test_card_branch_counts_triplets_and_entries():
    """Each call of ``to_ell`` (one path on every device) holds in its span
    ``SparseMatrix::to_ell`` the stream's length and its number of unique
    entries."""
    rows, cols, vals, shape = _stream("repeat200")
    nu = len(set(zip(rows.tolist(), cols.tolist())))
    timing.reset_trace()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                sparse.SparseMatrix(rows, cols, vals, shape,
                                    device="cpu").to_ell()
        recs = timing.spans()
    finally:
        timing.reset_trace()
    assert [r["name"] for r in recs] == ["SparseMatrix::to_ell"] * 2
    for r in recs:
        assert r["counters"] == {"SparseMatrix::to_ell::triplets": 500,
                                 "SparseMatrix::to_ell::entries": nu}
    assert nu < 500 - 199


@pytest.mark.cuda
def test_kernel_equals_plain_and_host_on_the_card():
    """On the card, ``a.mat`` of the fictdom3d forms at nx=24: the kernel's
    table equals the plain version's, on the card and on the CPU (the
    host's), bit for bit (one launch), and Jacobi-CG through it and through
    the host's table takes the same iterations to the same bits, as does
    ``Inverse(free) * f``.  The made-up streams of the CPU cases give the
    host's tables too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    for case in ("repeat200", "empty_rows", "rectangular", "float32",
                 "empty"):
        rows, cols, vals, shape = _stream(case)
        host = sparse.SparseMatrix(rows, cols, vals, shape,
                                   device="cpu").to_ell()
        card = sparse.SparseMatrix(rows, cols, vals, shape,
                                   device="cuda").to_ell()
        assert _same_table(card.cols, card.vals, host.cols, host.vals), case
    a, f, _, free, _ = fictdom3d.system(nx=24, device="cuda")
    a.Assemble()
    f.Assemble()
    S = a.mat
    before = coo_ell.launches
    card = S.to_ell()
    torch.cuda.synchronize()
    assert coo_ell.launches == before + 1
    rows, cols, vals = S.rows.cpu(), S.cols.cpu(), S.vals.cpu()
    host = sparse.SparseMatrix(rows, cols, vals, S.shape,
                               device="cpu").to_ell()
    c, v, _ = coo_ell.coo_to_ell(rows, cols, vals, S.shape)
    assert _same_table(card.cols, card.vals, host.cols, host.vals)
    assert _same_table(card.cols, card.vals, c, v)
    host_on_card = sparse.ELLMatrix(host.cols.cuda(), host.vals.cuda(),
                                    S.shape)
    free_t = krylov._free_mask(free, "cuda")
    b = as_input(f.vec, S)
    n = S.shape[0]
    x1, it1, _ = krylov._cg_ell(card, b, free_t, 20 * n,
                                sparse.INVERSE_CG_TOL)
    x2, it2, _ = krylov._cg_ell(host_on_card, b, free_t, 20 * n,
                                sparse.INVERSE_CG_TOL)
    assert int(it1) == int(it2) > 0
    assert torch.equal(_bits(x1), _bits(x2))
    inv = S.Inverse(free)
    assert inv.path == "device_cg"
    assert torch.equal(_bits(inv * f.vec), _bits(x1))
