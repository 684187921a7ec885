"""Matrix-free (partial-assembly) operator application.

Counterpart of ``ngsxfem_tpu/solvers/operator.py``: the per-element matrix
batches that ``BilinearForm`` assembles are applied directly,
``y = sum_k scatter(dm_v_k, m_k @ x[dm_u_k])``, without building the global
matrix (the reference always assembles through NGSolve's sparse matrix; cf.
"High-performance matrix-free unfitted finite element operator evaluation",
PAPERS.md).  The batched ``(E, ndv, ndu) x (E, ndu)`` contraction is one
``torch.matmul`` per part.  The contributions are added into ``y`` through
one ``ops.scatter.ScatterPlan`` over all parts, built once per operator, so
every apply is the same fixed-order sum on the CPU and on the card.  The
JAX package's gather table (``_pa_matvec_gather``), its answer to a TPU
scatter-add that serializes on duplicate indices, has no counterpart here.
"""
from __future__ import annotations

import torch

from ..ops.scatter import ScatterPlan


class PartialAssemblyOperator:
    """``y = A @ x`` from per-element matrix batches, never materializing A.

    ``parts``: list of ``(m (E, ndv, ndu), dm_v (E, ndv), dm_u (E, ndu))``
    tensors on one device, one entry per assembled batch (element rows,
    facet-patch or skeleton pairs, ...): the batches ``BilinearForm.Assemble``
    turns into triplets, with zeros at the slots it leaves out, so by
    linearity the product equals the assembled one to round-off.  ``shape``
    is (nrows, ncols); ``device`` and ``dtype`` are those of an operator
    without parts (the zero operator of an empty form)."""

    kind = "pa"

    def __init__(self, parts, shape, device=None, dtype=None):
        self.parts = [(m, dm_v.to(torch.int64), dm_u.to(torch.int64))
                      for m, dm_v, dm_u in parts]
        self.shape = tuple(int(n) for n in shape)
        if self.parts:
            device, dtype = self.parts[0][0].device, self.parts[0][0].dtype
        self.device, self.dtype = torch.device(device), dtype
        rows = [dm_v.reshape(-1) for _, dm_v, _ in self.parts]
        self._plan = ScatterPlan(
            torch.cat(rows) if rows else
            torch.zeros(0, dtype=torch.int64, device=self.device),
            self.shape[0])

    def matvec(self, x):
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        ys = [torch.matmul(m, x[dm_u].unsqueeze(-1)).reshape(-1)
              for m, _, dm_u in self.parts]
        if not ys:
            return torch.zeros(self.shape[0], dtype=x.dtype, device=x.device)
        return self._plan.add(torch.cat(ys))

    __matmul__ = matvec

    def __mul__(self, x):
        return self.matvec(x)

    def diagonal(self):
        """Exact diagonal of the (never materialized) matrix: the Jacobi
        preconditioner of CG/MINRES on this operator."""
        cs = [torch.where(dm_v[:, :, None] == dm_u[:, None, :], m,
                          0.0).sum(2).reshape(-1)
              for m, dm_v, dm_u in self.parts]
        if not cs:
            return torch.zeros(self.shape[0], dtype=self.dtype,
                               device=self.device)
        return self._plan.add(torch.cat(cs))

    def nbytes(self):
        """Bytes of the element batches and their dof maps."""
        return int(sum(t.numel() * t.element_size()
                       for p in self.parts for t in p))
