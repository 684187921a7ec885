"""COO triplets to the padded ``(n, K)`` ELL table, on the triplets' device.

``coo_to_ell`` is ``SparseMatrix.to_ell`` on every device.  It gives the
table of the JAX package's ``SparseMatrix.to_ell``, bit for bit: duplicate
(row, col) entries summed in f64 in stream order and rounded once to the
values' dtype, each row's entries in first-appearance order, padding col 0,
value 0, K the longest row (0 for a matrix with rows and no entry, 1 for one
with no row).  It reads the triplet stream where it lies and copies none of
it to the host:

1. ``key = row * ncols + col`` sorted stably (``torch.sort``): each run of
   equal keys, one unique entry, contiguous and in stream order;
2. the runs' starts (one host read: their number), each run's key and first
   stream position, the first run of each row (``searchsorted`` over the
   sorted rows) and K (the second host read, which also tells whether a
   row lies outside the matrix);
3. one pass, one unique entry at a time, that sums its run in f64 and puts
   it in its row at the slot given by the number of the row's entries that
   appear before it in the stream.

On a card (``on_card``) step 3 is the hand-written kernel
``csrc/coo_ell.cu`` (see the note at its top); elsewhere it is
``place_plain``, the same step in PyTorch.  There is no fallback between
the two: a CUDA tensor reaches the kernel or the call raises.
"""
from __future__ import annotations

import torch

from ..kernels.launch import I64, INT, PTR, Library, on_card

# launches of the CUDA kernel (one per `coo_to_ell` call on CUDA tensors with
# at least one entry)
launches = 0

_SIG = (PTR,) * 8 + (I64, I64, INT, PTR)
LIB = Library("coo_ell", {torch.float32: ("coo_ell_place_f32", _SIG),
                          torch.float64: ("coo_ell_place_f64", _SIG)})


def coo_to_ell(rows, cols, vals, shape):
    """``(cols (n, K) int32, vals (n, K), nu)``: the ELL table of the COO
    triplets ``rows``, ``cols`` (integer) and ``vals`` (T,) of a matrix of
    ``shape`` (n, ncols), on their device, and its number of unique
    entries.  A row outside [0, n) raises ``ValueError``, and values that
    require grad raise ``RuntimeError``: the table has no gradient."""
    if vals.requires_grad:
        raise RuntimeError("to_ell on values that require grad: the ELL "
                           "table has no gradient; detach them first")
    n, ncols = (int(s) for s in shape)
    dev = vals.device
    vals = vals.contiguous()
    T = vals.shape[0]
    skey, perm = torch.sort(rows.long() * ncols + cols.long(), stable=True)
    is_start = torch.ones(T, dtype=torch.bool, device=dev)
    is_start[1:] = skey[1:] != skey[:-1]
    starts = torch.nonzero(is_start).squeeze(1)
    nu = starts.numel()
    ukey = skey[starts]
    del skey, is_start
    first = perm[starts]
    starts = torch.cat([starts, starts.new_full((1,), T)])
    urow = torch.div(ukey, ncols, rounding_mode="floor")
    row_ptr = torch.searchsorted(urow, torch.arange(n + 1, device=dev))
    del urow
    # one host read: K, and whether some row lies outside [0, n)
    counts = row_ptr[1:] - row_ptr[:-1]
    K, outside = torch.stack([
        counts.max() if n else counts.new_ones(()),
        ((row_ptr[0] != 0) | (row_ptr[n] != nu)).long()]).tolist()
    if outside:
        raise ValueError(f"to_ell: a row index is outside [0, {n})")
    out_cols = torch.zeros((n, K), dtype=torch.int32, device=dev)
    out_vals = torch.zeros((n, K), dtype=vals.dtype, device=dev)
    place = _place_kernel if on_card(vals) else place_plain
    place(vals, perm, starts, ukey, first, row_ptr, out_cols, out_vals, ncols)
    return out_cols, out_vals, nu


def place_plain(vals, perm, starts, ukey, first, row_ptr, out_cols, out_vals,
                ncols):
    """The kernel's step in PyTorch: for each unique entry u, the sum of
    ``vals[perm[j]]`` over its run ``starts[u] <= j < starts[u + 1]``, added
    to 0.0 in f64 in that order and rounded once, written to its row
    ``ukey[u] // ncols`` at the slot that counts the row's entries whose
    first stream position ``first`` is smaller than its own."""
    nu = ukey.numel()
    if nu == 0:
        return
    K = out_cols.shape[1]
    s = starts[:-1]
    lens = starts[1:] - s
    v = vals.to(torch.float64)[perm]
    acc = torch.zeros(nu, dtype=torch.float64, device=vals.device)
    for j in range(int(lens.max())):
        acc = torch.where(lens > j, acc + v[(s + j).clamp(max=v.numel() - 1)],
                          acc)
    r = torch.div(ukey, ncols, rounding_mode="floor")
    b = row_ptr[r]
    cnt = row_ptr[r + 1] - b
    slot = torch.zeros(nu, dtype=torch.int64, device=vals.device)
    for k in range(K):
        slot += (cnt > k) & (first[(b + k).clamp(max=nu - 1)] < first)
    at = r * K + slot
    out_cols.view(-1)[at] = (ukey - r * ncols).to(torch.int32)
    out_vals.view(-1)[at] = acc.to(out_vals.dtype)


def _place_kernel(vals, perm, starts, ukey, first, row_ptr, out_cols,
                  out_vals, ncols):
    """``place_plain`` as one launch of ``csrc/coo_ell.cu`` on CUDA tensors
    (all int64 but ``out_cols``, contiguous, on one card)."""
    global launches
    if vals.dtype not in LIB.entries:
        raise ValueError(f"no coo_ell kernel for {vals.dtype}: vals must be "
                         f"float32 or float64")
    nu = ukey.numel()
    if nu == 0:
        return
    LIB.launch(vals.dtype, vals, vals.data_ptr(), perm.data_ptr(),
               starts.data_ptr(), ukey.data_ptr(), first.data_ptr(),
               row_ptr.data_ptr(), out_cols.data_ptr(), out_vals.data_ptr(),
               nu, ncols, out_cols.shape[1])
    launches += 1
