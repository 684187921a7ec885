"""Sparse matrices: COO triplets, padded ELL rows and offset diagonals.

Counterpart of ``ngsxfem_tpu/solvers/sparse.py:18-141,197-306``.  This
module holds the formats and the policy; each operation lives in its own
module (``coo_ell``, ``ell_spmv``, ``dia_spmv``) with its hand-written
kernel, its plain twin and the one device branch between them, on the
launcher's ``on_card``.
``SparseMatrix`` (COO, its product summed by ``index_add_`` on the CPU and
by a fixed-order ``ScatterPlan`` on the card, ``todense``, ``to_scipy``,
``Inverse``, ``CreateTranspose``) is plain PyTorch: the reference has no
Pallas kernel behind it either.  ``SparseMatrix.to_ell`` is
``coo_ell.coo_to_ell`` where the triplets lie (on the card its sum and
placement are the kernel ``csrc/coo_ell.cu``).  ``ELLMatrix.matvec`` is
``ell_spmv.ell_matvec`` on the matrix's cached sliced layout (on the card;
the CPU sums the table itself), on the card the kernel ``csrc/ell_spmv.cu``
(the reference's ``matvec_pallas`` has no separate counterpart); under
autograd its transposed product runs the same kernel on the cached
transposed table (``ELLMatrix.transposed``).  ``dia_matvec`` is
``dia_spmv.dia_matvec`` (on the card the kernel ``csrc/dia_spmv.cu``).
``InverseMatrix`` keeps the reference's dispatch with two changes on the
card: the named direct solvers factorize on the host with
scipy, ``"cg"`` runs Jacobi-CG on the ELL view of the matrix through that
kernel, and the default ``""`` does the same for a matrix on the card whose
free block is symmetric with a positive diagonal; any other free block it
factors densely on the card (``torch.linalg.lu_factor_ex``, a library's
LU as the reference leaves its dense products to XLA) where that fits
``_dense_lu_budget``, on the host with scipy where it does not.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import as_input, config, resolve_device
# the policy's one test of "on a card": the tests patch ``sparse._on_card``
# to take the card's policy (the default ``Inverse()``, the ``ScatterPlan``
# of the rows, the sliced layouts) on CPU tensors, whose products stay plain
from ..kernels.launch import on_card as _on_card
from ..ops.scatter import ScatterPlan
from ..utils.timing import Timer, count, traced
from .coo_ell import coo_to_ell
from .dia_spmv import dia_matvec, dia_matvec_plain  # noqa: F401 (public)
from .ell_spmv import ell_matvec, prepare_ell, transpose_ell
from .krylov import _cg_ell


class SparseMatrix:
    """COO triplets (duplicates summed by the product), shape (m, n).

    ``rows``/``cols``/``vals`` are numpy arrays or tensors; they are held
    as int32/int32/own-dtype tensors on ``device`` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, rows, cols, vals, shape, *, device=None):
        device = resolve_device(device)
        self.rows = torch.as_tensor(rows, device=device).to(torch.int32)
        self.cols = torch.as_tensor(cols, device=device).to(torch.int32)
        self.vals = torch.as_tensor(vals, device=device)
        self.shape = tuple(int(s) for s in shape)

    def _row_sums(self, terms):
        """The triplet stream ``terms`` summed into the rows: ``index_add_``
        (sequential) on the CPU, a ``ScatterPlan`` of the rows, built once,
        on the card, where ``index_add_`` is atomic; so a product repeats
        bit for bit."""
        y = torch.zeros(self.shape[0], dtype=self.vals.dtype,
                        device=self.vals.device)
        if not _on_card(self.vals):
            return y.index_add_(0, self.rows, terms)
        if not hasattr(self, "_rows_plan"):
            self._rows_plan = ScatterPlan(self.rows, self.shape[0])
        return self._rows_plan.add(terms, y)

    def matvec(self, x):
        """A @ x for a tensor, a dof-vector shim (``gf.vec``) or a numpy
        array."""
        return self._row_sums(self.vals * as_input(x, self)[self.cols])

    __mul__ = matvec
    __matmul__ = matvec

    def todense(self):
        A = torch.zeros(self.shape, dtype=self.vals.dtype,
                        device=self.vals.device)
        return A.index_put_((self.rows.long(), self.cols.long()), self.vals,
                            accumulate=True)

    def to_scipy(self):
        from scipy.sparse import coo_matrix

        return coo_matrix(
            (self.vals.detach().cpu().numpy(),
             (self.rows.cpu().numpy(), self.cols.cpu().numpy())),
            shape=self.shape,
        ).tocsc()

    def diagonal(self):
        return self._row_sums(torch.where(self.rows == self.cols, self.vals,
                                          0.0))

    @traced("SparseMatrix::to_ell")
    def to_ell(self):
        """Padded ELL copy (``coo_ell.coo_to_ell``, where the triplets lie):
        duplicate (row, col) entries summed in f64 in stream order, each
        row's entries in first-appearance order, padding col 0, val 0, as
        the reference's host conversion gives it, bit for bit."""
        cols, vals, nu = coo_to_ell(self.rows, self.cols, self.vals,
                                    self.shape)
        count("SparseMatrix::to_ell::triplets", self.vals.shape[0])
        count("SparseMatrix::to_ell::entries", nu)
        return ELLMatrix(cols, vals, self.shape)

    def ell(self):
        """Cached ELL view."""
        if not hasattr(self, "_ell"):
            self._ell = self.to_ell()
        return self._ell

    def Inverse(self, freedofs=None, inverse="", **kw):
        return InverseMatrix(self, freedofs, method=inverse)

    def CreateTranspose(self):
        return SparseMatrix(self.cols, self.rows, self.vals,
                            (self.shape[1], self.shape[0]),
                            device=self.vals.device)

    @property
    def T(self):
        return self.CreateTranspose()

    def __repr__(self):
        return f"SparseMatrix({self.shape}, nnz-triplets={self.vals.shape[0]})"


class ELLMatrix:
    """Padded-row sparse matrix: cols (n, K) int32, vals (n, K), shape
    (n, ncols).  ``matvec`` is ``ell_matvec`` on ``layout()``: the CUDA
    kernel on the card, the plain row sum on the CPU; under autograd its
    backward's transposed product runs the same way on ``transposed()``.
    The table is not to be changed in place: the layouts are copies of
    it."""

    def __init__(self, cols, vals, shape):
        self.cols = cols
        self.vals = vals
        self.shape = tuple(int(s) for s in shape)
        self._layout = None
        self._transposed = None

    @classmethod
    def from_numpy(cls, cols, vals, shape=None, *, device=None):
        """Build from host arrays (e.g. the reference package's
        ``np.asarray(ell.cols)``), keeping the dtype of ``vals``.  Checks
        once, here, that every column index lies in [0, ncols): the kernel
        reads x at them unchecked."""
        device = resolve_device(device)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        if cols.ndim != 2 or cols.shape != vals.shape:
            raise ValueError(f"cols {cols.shape} and vals {vals.shape} must "
                             f"be (n, K) of one shape")
        n = cols.shape[0]
        shape = (n, n) if shape is None else tuple(int(s) for s in shape)
        if shape[0] != n:
            raise ValueError(f"shape {shape} does not match {n} rows")
        if cols.size and (cols.min() < 0 or cols.max() >= shape[1]):
            raise ValueError(f"column indices must lie in [0, {shape[1]})")
        return cls(torch.as_tensor(cols.astype(np.int32), device=device),
                   torch.as_tensor(vals, device=device), shape)

    def layout(self):
        """The sliced layout of the table (``ell_spmv.prepare_ell``) on the
        card, made at the first product and kept while ``vals`` and ``cols``
        are the same tensors; None on the CPU, whose products sum the table
        itself."""
        if not _on_card(self.vals):
            return None
        lay = self._layout
        if lay is None or lay[0] is not self.vals or lay[1] is not self.cols:
            with torch.no_grad():
                lay = self._layout = (self.vals, self.cols, prepare_ell(
                    self.vals, self.cols, self.shape[1]))
        return lay[2]

    def transposed(self):
        """The ``ELLMatrix`` of the transpose (``ell_spmv.transpose_ell``,
        values detached), made at the first backward and kept, with its
        own layout, while ``vals`` and ``cols`` are the same tensors."""
        tr = self._transposed
        if tr is None or tr[0] is not self.vals or tr[1] is not self.cols:
            vt, ct = transpose_ell(self.vals.detach(), self.cols,
                                   self.shape[1])
            tr = self._transposed = (self.vals, self.cols, ELLMatrix(
                ct, vt, (self.shape[1], self.shape[0])))
        return tr[2]

    def matvec(self, x):
        """A @ x (x a tensor, or a numpy array made a tensor here).  Under
        autograd (``ell_spmv.EllMatvec``) the backward's ``A^T g`` is the
        product of ``transposed()``."""
        return ell_matvec(self.vals, self.cols, x, self.layout(),
                          lambda g: self.transposed().matvec(g))

    __mul__ = matvec
    __matmul__ = matvec

    def ell(self):
        """The ELL view: the matrix itself."""
        return self

    def diagonal(self):
        rid = torch.arange(self.shape[0], device=self.cols.device)[:, None]
        return torch.where(self.cols == rid, self.vals, 0.0).sum(1)


class DIAMatrix:
    """Offset-diagonal sparse matrix for stencil-structured operators.

    vals (n_off, n): diagonal k holds A[r, r + offsets[k]] at position r
    (absent entries zero).  Built by ``UnfittedPoisson.dia_structure`` +
    ``assemble_vals_lattice`` for structured meshes.
    """

    def __init__(self, offsets, vals):
        self.offsets = np.asarray(offsets)
        self.vals = vals
        n = vals.shape[1]
        self.shape = (n, n)

    @classmethod
    def from_numpy(cls, offsets, vals, *, device=None):
        """Build from host arrays (e.g. the reference package's
        ``np.asarray(V)``), keeping the dtype of ``vals``, on ``device`` (the
        card unless the caller asks for the CPU)."""
        return cls(offsets, torch.as_tensor(np.asarray(vals),
                                            device=resolve_device(device)))

    def matvec(self, x):
        return dia_matvec(self.offsets, self.vals, x)

    __mul__ = matvec
    __matmul__ = matvec

    def diagonal(self):
        k0 = np.flatnonzero(np.asarray(self.offsets) == 0)
        if k0.size != 1:
            raise ValueError("DIAMatrix has no offset-0 diagonal")
        return self.vals[int(k0[0])]


# relative residual of the Jacobi-CG of ``Inverse()`` ("cg", and the default
# on the card): its solutions are within 4.1e-12 of the host LU's on every
# ported example at the sizes chip_smoke.py solves (f64, nx <= 64 on the CPU)
INVERSE_CG_TOL = 1e-12
# symmetry the default ``Inverse()`` asks of the free block on the card, to
# this share of its largest entry
SPD_SYM_TOL = 1e-12


@traced("spd_free_block")
def spd_free_block(ell, free):
    """Whether the free block of the ELL matrix is symmetric to
    ``SPD_SYM_TOL`` of its largest entry with a positive diagonal: the
    matrices on which the default ``Inverse()`` runs Jacobi-CG.  ``free`` is
    a bool tensor on the matrix's device; the check runs there and reads
    one bool back."""
    n = ell.shape[0]
    cols = ell.cols.long()
    rows = torch.arange(n, device=cols.device)[:, None].expand_as(cols)
    sel = free[rows] & free[cols] & (ell.vals != 0)
    r, c, v = rows[sel], cols[sel], ell.vals[sel]
    ok = (ell.diagonal()[free] > 0).all()
    if v.numel():
        key, order = torch.sort(r * n + c)
        tkey = c * n + r
        pos = torch.searchsorted(key, tkey).clamp(max=key.numel() - 1)
        vt = torch.where(key[pos] == tkey, v[order[pos]], 0.0)
        ok = ok & ((v - vt).abs().max() <= SPD_SYM_TOL * v.abs().max())
    return bool(ok)


def _dense_lu_budget(device):
    """Bytes the dense LU of the default ``Inverse()`` may hold on
    ``device``: the smaller of a quarter of the card's memory and what is
    free there (``torch.cuda.mem_get_info``'s free bytes and the caching
    allocator's reserved but unallocated ones); 0 off CUDA."""
    if device.type != "cuda":
        return 0
    free, total = torch.cuda.mem_get_info(device)
    spare = (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    return min(total // 4, free + spare)


def _dense_lu_bytes(nf, ell):
    """Bytes the dense LU of an ``nf``-row free block of ``ell`` holds on
    the card at most: the float64 input and its factor, ``2 nf^2`` values
    alive together in ``lu_factor_ex``, and the four (n, K) temporaries of
    8 bytes that write the input (the free-index map of the columns, the
    flat positions, their product, the values in float64)."""
    return 8 * (2 * nf * nf + 4 * ell.cols.numel())


class InverseMatrix:
    """Solver object: `inv * rhs` solves on the free dofs (zero elsewhere).

    method: NGSolve direct-solver names ("sparsecholesky", "umfpack",
    "pardiso", "masterinverse") dispatch to the host scipy LU; "cg" runs
    the device Jacobi-CG path (``krylov._cg_ell`` on the ELL view, every
    product through ``ell_matvec``) to ``INVERSE_CG_TOL``.  The default ""
    chooses, once, here, between three paths (``path`` records it):

    - "device_cg": a matrix on the card whose free block passes
      ``spd_free_block``; the solve raises ``RuntimeError`` if it misses
      ``INVERSE_CG_TOL`` within its steps;
    - "device_lu": any other matrix on the card whose dense LU fits the
      card: ``_dense_lu_bytes`` (the input and its factor, ``2 nf^2``
      float64 values for ``nf`` free rows, and the temporaries that write
      the input) within ``_dense_lu_budget``, read here.  At the first
      solve the free block of the ELL view is written into a dense float64
      matrix on the card and factored with partial pivoting
      (``torch.linalg.lu_factor_ex``); each solve is ``lu_solve`` there, with
      no host round trip;
    - "host_lu": everything else, and every matrix on the CPU: the
      reference's default, scipy's ``splu`` of the free block in float64,
      factored at the first solve.

    Both LUs raise ``RuntimeError`` on an exactly singular free block and
    return ``config.dtype``.  Unknown names raise instead of being silently
    ignored.
    """

    _DIRECT = ("", "sparsecholesky", "umfpack", "pardiso", "masterinverse")

    @traced("InverseMatrix::InverseMatrix")
    def __init__(self, mat: SparseMatrix, freedofs=None, method=""):
        if mat.shape[0] != mat.shape[1]:
            raise ValueError(
                f"Inverse of a rectangular matrix {mat.shape}; "
                "Petrov-Galerkin systems must be square to solve")
        self.mat = mat
        self.method = str(method or "").lower()
        if self.method not in self._DIRECT + ("cg",):
            raise ValueError(
                f"unknown inverse method {method!r}; use one of "
                f"{self._DIRECT + ('cg',)}")
        n = mat.shape[0]
        if freedofs is None:
            self.free = np.ones(n, dtype=bool)
        else:
            from ..fem.space import _arr

            self.free = _arr(freedofs)
        self._factor = None
        self.path = "host_lu"
        if self.method == "cg" or (self.method == "" and _on_card(mat.vals)):
            self._free_t = torch.as_tensor(self.free, device=mat.vals.device)
            if self.method == "cg" or spd_free_block(mat.ell(), self._free_t):
                self.path = "device_cg"
            else:
                nf = int(np.count_nonzero(self.free))
                if (_dense_lu_bytes(nf, mat.ell())
                        <= _dense_lu_budget(mat.vals.device)):
                    self.path = "device_lu"

    def _factorize(self):
        if self._factor is None:
            from scipy.sparse.linalg import splu

            A = self.mat.to_scipy().tocsr()
            idx = np.nonzero(self.free)[0]
            # factorized in float64, the right-hand side's dtype here
            Af = A[idx][:, idx].tocsc().astype(np.float64, copy=False)
            self._factor = (splu(Af), idx)
            count("InverseMatrix::host_lu::rows", len(idx))
        return self._factor

    def _factorize_on_card(self):
        """The dense LU of the free block where the matrix lies: the ELL
        view's entries (``to_ell`` summed each (row, col) once, padding
        holds zeros) written through a free-index map into a zeroed
        float64 (nf, nf) matrix, then ``lu_factor_ex``; one read of its
        ``info``."""
        if self._factor is None:
            ell = self.mat.ell()
            dev = ell.vals.device
            idx = torch.as_tensor(np.flatnonzero(self.free), device=dev)
            nf = idx.numel()
            pos = torch.full((self.mat.shape[0],), -1, dtype=torch.long,
                             device=dev)
            pos[idx] = torch.arange(nf, device=dev)
            r = pos[:, None].expand_as(ell.cols)
            c = pos[ell.cols.long()]
            keep = (r >= 0) & (c >= 0) & (ell.vals != 0)
            # entries off the free block go to one spare slot past the end
            flat = torch.where(keep, r * nf + c, nf * nf)
            A = torch.zeros(nf * nf + 1, dtype=torch.float64, device=dev)
            A[flat] = ell.vals.to(torch.float64)
            del pos, r, c, keep, flat
            LU, piv, info = torch.linalg.lu_factor_ex(A[:-1].view(nf, nf))
            del A
            if int(info):
                raise RuntimeError(
                    f"Inverse(): the free block is exactly singular (pivot "
                    f"{int(info)} of {nf} is zero in its LU on the card)")
            self._factor = (LU, piv, idx)
            count("InverseMatrix::device_lu::rows", nf)
        return self._factor

    @traced("InverseMatrix::Solve")
    def solve(self, rhs):
        rhs = as_input(rhs, self.mat)
        if self.path == "device_cg":  # no host round trip
            tol = INVERSE_CG_TOL
            x, iters, res = _cg_ell(self.mat.ell(), rhs, self._free_t,
                                    20 * self.mat.shape[0], tol)
            if self.method == "":
                bn = torch.linalg.vector_norm(torch.where(self._free_t, rhs,
                                                          0.0))
                if not bool(res <= tol * bn.clamp_min(1e-30)):
                    raise RuntimeError(
                        f"Inverse(): Jacobi-CG on the card reached a relative "
                        f"residual of {float(res / bn.clamp_min(1e-30)):.3e}, "
                        f"not {tol:.0e}, in {iters} iterations; ask for the "
                        f"host LU with inverse=\"umfpack\"")
            return x
        if self.path == "device_lu":  # no host round trip either
            with Timer("InverseMatrix::device_lu", block=False), \
                    torch.no_grad():
                LU, piv, idx = self._factorize_on_card()
                b = rhs.to(torch.float64)[idx, None]
                out = torch.zeros(self.mat.shape[0], dtype=torch.float64,
                                  device=idx.device)
                out[idx] = torch.linalg.lu_solve(LU, piv, b)[:, 0]
                return out.to(config.dtype)
        # the host LU: factorized at the first solve (to_scipy, the free
        # block, splu), then a triangular solve with its copies each call
        with Timer("InverseMatrix::host_lu", block=False):
            rhs_np = torch.as_tensor(rhs).detach().cpu().numpy().astype(
                np.float64)
            lu, idx = self._factorize()
            out = np.zeros_like(rhs_np)
            out[idx] = lu.solve(rhs_np[idx])
            return torch.as_tensor(out, dtype=config.dtype,
                                   device=self.mat.vals.device)

    def __mul__(self, rhs):
        return self.solve(rhs)

    def __matmul__(self, rhs):
        return self.solve(rhs)
