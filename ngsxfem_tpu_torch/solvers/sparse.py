"""Sparse matrices: COO triplets, padded ELL rows and offset diagonals.

Counterpart of ``ngsxfem_tpu/solvers/sparse.py:18-141,197-306``.
``SparseMatrix`` (COO, ``index_add_`` product, ``todense``, ``to_scipy``,
``Inverse``, ``CreateTranspose``) and the DIA operator are plain PyTorch:
the reference has no Pallas kernel behind them either.
``ELLMatrix.matvec`` is ``ell_spmv.ell_matvec`` on the matrix's cached
sliced layout (on the card; the CPU sums the table itself), which on CUDA
tensors is the hand-written kernel
``csrc/ell_spmv.cu`` (the reference's ``matvec_pallas`` has no separate
counterpart).  ``InverseMatrix`` keeps the reference's dispatch with one
change on the card: the named direct solvers factorize on the host with
scipy, ``"cg"`` runs Jacobi-CG on the ELL view of the matrix through that
kernel, and the default ``""`` does the same for a matrix on the card whose
free block is symmetric with a positive diagonal (the host LU otherwise).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import config, resolve_device
from . import ell_spmv
from .ell_spmv import ell_matvec, prepare_ell


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
    (n, ncols).  ``matvec`` is ``ell_matvec`` on ``layout()``: the CUDA
    kernel on the card, the plain row sum on the CPU.  The table is not to
    be changed in place: the layout is a copy of it."""

    def __init__(self, cols, vals, shape):
        self.cols = cols
        self.vals = vals
        self.shape = tuple(int(s) for s in shape)
        self._layout = None

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
        itself (``ell_spmv.uses_layout``)."""
        if not ell_spmv.uses_layout(self.vals):
            return None
        lay = self._layout
        if lay is None or lay[0] is not self.vals or lay[1] is not self.cols:
            lay = self._layout = (self.vals, self.cols, prepare_ell(
                self.vals, self.cols, self.shape[1]))
        return lay[2]

    def matvec(self, x):
        return ell_matvec(self.vals, self.cols, x, self.layout())

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


# relative residual of the Jacobi-CG of ``Inverse()`` ("cg", and the default
# on the card): its solutions are within 4.1e-12 of the host LU's on every
# ported example at the sizes chip_smoke.py solves (f64, nx <= 64 on the CPU)
INVERSE_CG_TOL = 1e-12
# symmetry the default ``Inverse()`` asks of the free block on the card, to
# this share of its largest entry
SPD_SYM_TOL = 1e-12


def _on_card(mat):
    """Whether the matrix lies on a CUDA card (the tests patch this to run
    the card's branch of ``InverseMatrix`` on CPU tensors)."""
    return mat.vals.is_cuda


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


class InverseMatrix:
    """Solver object: `inv * rhs` solves on the free dofs (zero elsewhere).

    method: NGSolve direct-solver names ("sparsecholesky", "umfpack",
    "pardiso", "masterinverse") dispatch to the host scipy LU; "cg" runs
    the device Jacobi-CG path (``krylov._cg_ell`` on the ELL view, every
    product through ``ell_matvec``) to ``INVERSE_CG_TOL``.  The
    default "" takes that device path for a matrix on the card whose free
    block passes ``spd_free_block`` (checked once, here), and raises
    ``RuntimeError`` if the solve misses ``INVERSE_CG_TOL`` within its
    steps; any other matrix, and every matrix on the CPU, gets the host LU,
    the reference's default.  ``path`` records the choice: "device_cg" or
    "host_lu".  Unknown names raise instead of being silently ignored.
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
        self.path = "host_lu"
        if self.method == "cg" or (self.method == "" and _on_card(mat)):
            self._free_t = torch.as_tensor(self.free, device=mat.vals.device)
            if self.method == "cg" or spd_free_block(mat.ell(), self._free_t):
                self.path = "device_cg"

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
        if self.path == "device_cg":  # no host round trip
            from .krylov import _cg_ell

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
