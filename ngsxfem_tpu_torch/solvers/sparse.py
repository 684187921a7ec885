"""Sparse matrices: COO triplets, padded ELL rows and offset diagonals.

Counterpart of ``ngsxfem_tpu/solvers/sparse.py:18-141,197-306``.
``SparseMatrix`` (COO, ``index_add_`` product, ``todense``, ``to_scipy``,
``Inverse``, ``CreateTranspose``) and the DIA operator are plain PyTorch:
the reference has no Pallas kernel behind them either.
``ELLMatrix.matvec`` is ``ell_spmv.ell_matvec``, which on CUDA tensors is
the hand-written kernel ``csrc/ell_spmv.cu`` (the reference's
``matvec_pallas`` has no separate counterpart).  ``InverseMatrix`` keeps the
reference's dispatch: the direct-solver names factorize on the host with
scipy, ``"cg"`` runs Jacobi-CG on the ELL view of the matrix, through that
kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import config, resolve_device
from .ell_spmv import ell_matvec


def _as_array(x):
    """The tensor behind a dof-vector shim (``gf.vec``, ``f.vec``), or
    ``x`` itself."""
    from ..fem.gridfunction import VecShim, StandaloneVec

    return x.data if isinstance(x, (VecShim, StandaloneVec)) else x


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

    def matvec(self, x):
        """A @ x for a tensor or a dof-vector shim (``gf.vec``)."""
        x = _as_array(x)
        y = torch.zeros(self.shape[0], dtype=self.vals.dtype,
                        device=self.vals.device)
        return y.index_add_(0, self.rows, self.vals * x[self.cols])

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
        d = torch.zeros(self.shape[0], dtype=self.vals.dtype,
                        device=self.vals.device)
        on = self.rows == self.cols
        return d.index_add_(0, self.rows, torch.where(on, self.vals, 0.0))

    def to_ell(self):
        """Padded ELL copy (host conversion, as the reference's): duplicate
        (row, col) entries summed in f64 through the native open-addressing
        dedup, each row's entries in first-appearance order, padding col 0,
        val 0."""
        from ..mesh.native import unique_i64

        rows = self.rows.cpu().numpy()
        cols = self.cols.cpu().numpy()
        vals = self.vals.cpu().numpy()
        n = self.shape[0]
        lin = rows.astype(np.int64) * self.shape[1] + cols
        uniq, inv = unique_i64(lin)
        nu = len(uniq)
        sums = np.bincount(inv, weights=vals, minlength=nu).astype(vals.dtype)
        urows = (uniq // self.shape[1]).astype(np.int32)
        ucols = (uniq % self.shape[1]).astype(np.int32)
        counts = np.bincount(urows, minlength=n)
        K = int(counts.max()) if len(counts) else 1
        ell_cols = np.zeros((n, K), dtype=np.int32)
        ell_vals = np.zeros((n, K), dtype=vals.dtype)
        row_start = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=row_start[1:])
        order = np.argsort(urows, kind="stable")
        pos = np.empty(nu, dtype=np.int64)
        pos[order] = np.arange(nu) - row_start[urows[order]]
        ell_cols[urows, pos] = ucols
        ell_vals[urows, pos] = sums
        return ELLMatrix.from_numpy(ell_cols, ell_vals, self.shape,
                                    device=self.vals.device)

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
    (n, ncols).  ``matvec`` is ``ell_matvec``: the CUDA kernel on the card,
    its plain version on the CPU."""

    def __init__(self, cols, vals, shape):
        self.cols = cols
        self.vals = vals
        self.shape = tuple(int(s) for s in shape)

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

    def matvec(self, x):
        return ell_matvec(self.vals, self.cols, x)

    __mul__ = matvec
    __matmul__ = matvec

    def diagonal(self):
        rid = torch.arange(self.shape[0], device=self.cols.device)[:, None]
        return torch.where(self.cols == rid, self.vals, 0.0).sum(1)


def dia_matvec(offsets, vals, x):
    """Offset-diagonal (DIA) SpMV: y[r] = sum_k vals[k, r] * x[r + o_k].

    `offsets` are host ints; each diagonal contributes one static shifted
    slice of x and an elementwise multiply-add.  Entries off the right/left
    end of a diagonal read zero padding, so boundary rows need no masking.
    """
    offs = [int(o) for o in np.asarray(offsets).tolist()]
    n = x.shape[0]
    mneg = max(-min(offs), 0)
    mpos = max(max(offs), 0)
    xp = F.pad(x, (mneg, mpos))
    y = None
    for k, o in enumerate(offs):
        t = vals[k] * xp[mneg + o:mneg + o + n]
        y = t if y is None else y + t
    return y


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


class InverseMatrix:
    """Solver object: `inv * rhs` solves on the free dofs (zero elsewhere).

    method: NGSolve direct-solver names ("", "sparsecholesky", "umfpack",
    "pardiso", "masterinverse") all dispatch to the host scipy LU;
    "cg" runs the device Jacobi-CG path (``krylov.CGSolver`` on the ELL view,
    every product through ``ell_matvec``) for large SPD systems.  Unknown
    names raise instead of being silently ignored.
    """

    _DIRECT = ("", "sparsecholesky", "umfpack", "pardiso", "masterinverse")

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

    def _factorize(self):
        if self._factor is None:
            from scipy.sparse.linalg import splu

            A = self.mat.to_scipy().tocsr()
            idx = np.nonzero(self.free)[0]
            Af = A[idx][:, idx].tocsc()
            self._factor = (splu(Af), idx)
        return self._factor

    def solve(self, rhs):
        rhs = _as_array(rhs)
        if self.method == "cg":  # device path, no host round trip
            from .krylov import CGSolver

            return CGSolver(self.mat, freedofs=None if self.free.all()
                            else self.free, maxsteps=20 * self.mat.shape[0],
                            tol=1e-12) * rhs
        rhs_np = torch.as_tensor(rhs).detach().cpu().numpy().astype(np.float64)
        lu, idx = self._factorize()
        out = np.zeros_like(rhs_np)
        out[idx] = lu.solve(rhs_np[idx])
        return torch.as_tensor(out, dtype=config.dtype,
                               device=self.mat.vals.device)

    def __mul__(self, rhs):
        return self.solve(rhs)

    def __matmul__(self, rhs):
        return self.solve(rhs)
