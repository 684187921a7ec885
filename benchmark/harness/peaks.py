"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates) and the
least time a piece of work needs on it.

Copied from the repository's ``chip_smoke.py`` (``bound``, ``nnz_bound``,
``dia_cg_bound`` and the peaks beside them), so that the yardstick stays
with the benchmark.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12      # H100 SXM, f32 outside the tensor cores
F64_FLOP_PER_S = 34e12      # H100 SXM, f64 outside the tensor cores


def bound(nbytes, flops, flop_per_s=F32_FLOP_PER_S):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over HBM bandwidth and the operations over the
    peak rate of their type (f32 unless given)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / flop_per_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nnz_bound(nnz, n, ncols, itemsize):
    """A sparse product whatever layout implements it: each of the
    operator's ``nnz`` real slots (value and int32 column) and x read once,
    y written once; 2 flops per slot."""
    return bound(nnz * (4 + itemsize) + ncols * itemsize + n * itemsize,
                 2 * nnz, F64_FLOP_PER_S if itemsize == 8 else F32_FLOP_PER_S)


def dia_cg_bound(offsets, n, iters):
    """A fused DIA Jacobi-PCG call: inputs read once (the main and upper
    diagonals, b, dinv), x written once; per iteration 2 flops per offset
    per row for the product plus 11 per row for the dots and updates."""
    rows = sum(1 for o in np.asarray(offsets).tolist() if o >= 0)
    return bound((rows * n + 2 * n) * 4 + n * 4,
                 iters * (2 * len(offsets) + 11) * n + 5 * n)


# vectors a preconditioned CG iteration reads (x, r, p and the inverse
# diagonal) and writes (x, r, p), each once, beside its product
CG_VECTORS_PER_ITER = 7


def solve_least_s(products, iterations):
    """(seconds, "bytes" or "operations"): the least time of a Krylov solve
    whose inputs need this work.

    ``products``: (count, nnz, n, itemsize, col_bytes) per kind of product:
    each product reads the operator's real slots (value and, where the
    operator needs one, a ``col_bytes`` column) and x, and writes y; 2
    flops per slot.  ``iterations``: (count, n, itemsize) per kind of CG
    iteration, each moving ``CG_VECTORS_PER_ITER`` vectors, 11 flops per
    row.  Operations count at the peak of their dtype."""
    nbytes = t_ops = 0.0
    for count, nnz, n, itemsize, col_bytes in products:
        nbytes += count * (nnz * (itemsize + col_bytes) + 2 * n * itemsize)
        t_ops += count * 2 * nnz / _peak(itemsize)
    for count, n, itemsize in iterations:
        nbytes += count * CG_VECTORS_PER_ITER * n * itemsize
        t_ops += count * 11 * n / _peak(itemsize)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _peak(itemsize):
    return F64_FLOP_PER_S if itemsize == 8 else F32_FLOP_PER_S
