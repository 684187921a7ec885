"""Offset-diagonal (DIA) sparse operator.

Counterpart of ``ngsxfem_tpu/solvers/sparse.py:197-245``.  Plain PyTorch:
the reference has no Pallas kernel behind these either (XLA fuses its
shifted multiply-adds).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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
    def from_numpy(cls, offsets, vals, device):
        """Build from host arrays (e.g. the reference package's
        ``np.asarray(V)``), keeping the dtype of ``vals``."""
        return cls(offsets, torch.as_tensor(np.asarray(vals), device=device))

    def matvec(self, x):
        return dia_matvec(self.offsets, self.vals, x)

    __mul__ = matvec
    __matmul__ = matvec

    def diagonal(self):
        k0 = np.flatnonzero(np.asarray(self.offsets) == 0)
        if k0.size != 1:
            raise ValueError("DIAMatrix has no offset-0 diagonal")
        return self.vals[int(k0[0])]
