"""ELL SpMV: ``y[r] = sum_k vals[r, k] * x[cols[r, k]]``.

Counterpart of ``ngsxfem_tpu/solvers/sparse.py:131-194`` (``ELLMatrix.matvec``
and its Pallas kernel ``_matvec_pallas_impl``).  The reference's row-padded
``(n, K)`` table stays the port's public form.  On the card the product runs
on a sliced copy of it (SELL-32-1024, ``prepare_ell``: rows sorted by
length inside windows of 1024 rows, then in slices of 32, each slice padded
to its own longest row and stored slot-major), through the
hand-written Hopper kernel ``csrc/ell_spmv.cu`` (see the note at the top of
that file for its design and what bounds it).  A solver builds the layout
once per table and hands it to every product (``ELLMatrix.layout``,
which every solver's products go through).

``ell_matvec`` holds the product's one device branch: on a card
(``on_card``) the kernel, elsewhere ``ell_matvec_plain`` on the ``(n, K)``
table, where ``ELLMatrix`` builds no layout.  ``sell_matvec_plain`` is the
kernel's reference: its sum, in plain PyTorch.  There is no fallback
between kernel and plain: a CUDA tensor reaches the kernel or the call
raises.

Under autograd (grad mode on and ``vals`` or ``x`` requiring a gradient)
the product is ``EllMatvec``, the counterpart of ``jax.vjp`` of the
reference's plain ``ELLMatrix.matvec``: its forward is the same product,
its backward ``grad_x = A^T g`` through the same ``ell_matvec`` on the
transposed table (``transpose_ell``; on the card the kernel on that
table's layout) and ``grad_vals[r, k] = g[r] * x[cols[r, k]]``, a gather
and a product.
"""
from __future__ import annotations

import torch

from ..config import as_input
from ..kernels.launch import I64, INT, PTR, Library, on_card
from ..utils.timing import traced

# launches of the CUDA kernel (one per `ell_matvec` call on CUDA tensors with
# at least one row) and layouts made by `prepare_ell`; read and reset by
# chip_smoke.py
launches = 0
layouts_built = 0

SLICE = 32     # rows per slice: one warp of the kernel
WINDOW = 1024  # rows sorted by length inside windows of this many rows

_SIG = (PTR,) * 7 + (INT, I64, PTR)
LIB = Library("ell_spmv", {torch.float32: ("sell_spmv_f32", _SIG),
                           torch.float64: ("sell_spmv_f64", _SIG),
                           "kernel_info": ("sell_spmv_kernel_info", (PTR,))})


class SellLayout:
    """A SELL-32-1024 copy of an ``(n, K)`` ELL table (``prepare_ell``).

    ``rows`` (n,) int32: the table row at each sorted position.
    ``vals``/``cols`` (slots,) slot-major per slice: lane l of slot k of
    slice s (sorted position 32 * s + l) at ``slice_ptr[s] + 32 * k + l``;
    ``slice_ptr`` (nslices + 1,) int64, ``slice_K`` (nslices,) int32; host
    ints ``n``, ``ncols``, ``kmax`` (the largest ``slice_K``) and ``nnz``
    (the real slots: the sum of the row lengths)."""

    def __init__(self, slice_ptr, slice_K, rows, vals, cols, n, ncols, kmax,
                 nnz):
        self.slice_ptr = slice_ptr
        self.slice_K = slice_K
        self.rows = rows
        self.vals = vals
        self.cols = cols
        self.n = n
        self.ncols = ncols
        self.kmax = kmax
        self.nnz = nnz
        self._plain_idx = None

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def nslices(self):
        return self.slice_K.shape[0]

    @property
    def fill(self):
        """Real slots over stored slots (1.0 for a layout with no slot)."""
        stored = self.vals.shape[0]
        return self.nnz / stored if stored else 1.0

    def plain_index(self):
        """(kmax, nslices * 32) positions into ``vals`` of slot k of every
        row, ``vals.shape[0]`` (a sentinel) where slot k lies past its
        slice's ``slice_K``; built at the first plain product."""
        if self._plain_idx is None:
            dev = self.slice_K.device
            k = torch.arange(self.kmax, device=dev)[:, None, None]
            lane = torch.arange(SLICE, device=dev)[None, None, :]
            pos = self.slice_ptr[:-1][None, :, None] + SLICE * k + lane
            live = k < self.slice_K[None, :, None].to(torch.int64)
            self._plain_idx = torch.where(live, pos, self.vals.shape[0]) \
                .reshape(self.kmax, self.nslices * SLICE)
        return self._plain_idx


def ell_matvec_plain(vals, cols, x):
    """The row-padded sum in PyTorch: ``y = 0; y = y + vals[:, k] *
    x[cols[:, k]]`` for k = 0..K-1, one rounding per product and per sum.
    (``torch.sum(vals * x[cols], 1)`` reduces in no fixed order.)  The
    products are formed in one pass, slot-major, and summed slot by slot."""
    prods = (vals * x[cols]).T.contiguous()  # (K, n)
    y = torch.zeros(vals.shape[0], dtype=vals.dtype, device=vals.device)
    for k in range(vals.shape[1]):
        y = y + prods[k]
    return y


def sell_matvec_plain(layout, x):
    """The kernel's sum in PyTorch: the layout's slots, in the kernel's
    order (slot k = 0..slice_K[s]-1 of each row, one rounding per product
    and per sum), so on the card it equals the kernel bit for bit.  A slot
    past its slice's ``slice_K`` adds -0.0, which leaves every value as it
    is."""
    L = layout
    prods = L.vals * x[L.cols]
    P = torch.cat([prods, prods.new_full((1,), -0.0)])[L.plain_index()]
    ys = torch.zeros(L.nslices * SLICE, dtype=L.dtype, device=L.device)
    for k in range(L.kmax):
        ys = ys + P[k]
    y = torch.empty(L.n, dtype=L.dtype, device=L.device)
    y[L.rows.long()] = ys[:L.n]
    return y


def _check_table(vals, cols):
    if vals.dim() != 2 or cols.dim() != 2 or tuple(cols.shape) != tuple(vals.shape):
        raise ValueError(f"vals and cols must be (n, K) of one shape, got "
                         f"{tuple(vals.shape)} and {tuple(cols.shape)}")
    if vals.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"vals must be float32 or float64, got {vals.dtype}")
    if cols.dtype != torch.int32:
        raise ValueError(f"cols must be int32, got {cols.dtype}")
    if vals.device != cols.device:
        raise ValueError(f"vals on {vals.device}, cols on {cols.device}: "
                         f"both must share one device")
    for name, t in (("vals", vals), ("cols", cols)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(vals, cols, x):
    _check_table(vals, cols)
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got {tuple(x.shape)}")
    if x.dtype != vals.dtype:
        raise ValueError(f"vals and x must share float32 or float64, got "
                         f"{vals.dtype} and {x.dtype}")
    if x.device != vals.device:
        raise ValueError(f"vals on {vals.device}, x on {x.device}: all must "
                         f"share one device")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


@traced("prepare_ell")
def prepare_ell(vals, cols, ncols=None):
    """The SELL-32-1024 layout of the ELL table (vals, cols) (n, K), for x
    of length ``ncols`` (default n), built with torch ops on the table's
    device.

    A copy of the table: a new table needs a new layout.  Each row's length
    is one past its last slot that is not padding (col 0, value +-0); every
    slot before that stays.  Inside each window of ``WINDOW`` rows the rows
    are sorted by length, longest first, stably.  Adds one to
    ``layouts_built``."""
    global layouts_built
    _check_table(vals, cols)
    n, K = vals.shape
    dev = vals.device
    ns = -(-n // SLICE)
    real = (cols != 0) | (vals != 0)  # NaN != 0: a NaN slot is real
    rowlen = torch.zeros(n, dtype=torch.int64, device=dev)
    if n and K:
        rowlen = torch.where(real, torch.arange(1, K + 1, device=dev),
                             0).amax(1)
    pos = torch.arange(n, device=dev)
    rows = torch.argsort(pos // WINDOW * (K + 1) + (K - rowlen), stable=True)
    sorted_len = torch.zeros(ns * SLICE, dtype=torch.int64, device=dev)
    sorted_len[:n] = rowlen[rows]
    slice_K = sorted_len.view(ns, SLICE).amax(1)
    slice_ptr = torch.zeros(ns + 1, dtype=torch.int64, device=dev)
    slice_ptr[1:] = torch.cumsum(slice_K * SLICE, 0)
    keep = torch.arange(K, device=dev)[None, :] < slice_K[:, None]  # (ns, K)

    def slot_major(t):
        tp = torch.zeros((ns * SLICE, K), dtype=t.dtype, device=dev)
        tp[:n] = t[rows]
        return tp.view(ns, SLICE, K).transpose(1, 2)[keep].reshape(-1)

    kmax = int(slice_K.max()) if ns else 0
    layout = SellLayout(slice_ptr, slice_K.to(torch.int32), rows.to(torch.int32),
                        slot_major(vals), slot_major(cols), n,
                        n if ncols is None else int(ncols), kmax,
                        int(rowlen.sum()))
    layouts_built += 1
    return layout


def kernel_info(device):
    """{dtype name: (registers per thread, static shared memory bytes, local
    memory bytes per thread)} of the two compiled kernels on ``device``."""
    info = LIB.ints("kernel_info", device, 6)
    return {"float32": tuple(info[0:3]), "float64": tuple(info[3:6])}


def transpose_ell(vals, cols, ncols):
    """The ELL table (vals_T, cols_T) (ncols, K_T) of the transpose of the
    (n, K) table (vals, cols) with ``ncols`` columns, built with torch ops
    on the table's device (one host read: K_T).  Padding slots (col 0,
    value +-0) are left out; every other slot (r, k) becomes an entry of
    row ``cols[r, k]`` at column r, each row's entries in ascending r (then
    k), padded with col 0, value 0."""
    n, K = vals.shape
    dev = vals.device
    real = ((cols != 0) | (vals != 0)).reshape(-1)
    src = torch.arange(n * K, device=dev)[real]
    rows_t = cols.reshape(-1)[src].to(torch.int64)
    order = torch.argsort(rows_t, stable=True)
    rows_t, src = rows_t[order], src[order]
    counts = torch.bincount(rows_t, minlength=ncols)
    kt = max(int(counts.max()), 1) if rows_t.numel() else 1
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(rows_t.numel(), device=dev) - start[rows_t]
    vals_t = torch.zeros((ncols, kt), dtype=vals.dtype, device=dev)
    cols_t = torch.zeros((ncols, kt), dtype=torch.int32, device=dev)
    vals_t[rows_t, pos] = vals.reshape(-1)[src]
    cols_t[rows_t, pos] = torch.div(src, K, rounding_mode="floor").to(
        torch.int32)
    return vals_t, cols_t


class EllMatvec(torch.autograd.Function):
    """``y = A x`` for the ELL table A = (vals, cols) under autograd.

    ``adjoint(g)`` computes ``A^T g`` (``ELLMatrix`` hands in its cached
    transposed table; a raw ``ell_matvec`` builds the transposed table in
    the backward).  Forward and transposed products are ``ell_matvec`` calls:
    each one a launch of the kernel on the card, ``ell_matvec_plain`` on
    the CPU.  ``grad_vals`` is ``g[r] * x[cols[r, k]]`` for every slot,
    padding included, as ``jax.vjp`` of the reference's ``jnp.sum(vals *
    x[cols], 1)`` gives it.  No second derivative."""

    @staticmethod
    def forward(ctx, vals, x, cols, layout, adjoint):
        ctx.save_for_backward(x, cols)
        ctx.adjoint = adjoint
        return _ell_matvec(vals, cols, x, layout)

    @staticmethod
    def backward(ctx, g):
        x, cols = ctx.saved_tensors
        g = g.contiguous()
        gvals = gx = None
        if ctx.needs_input_grad[1]:
            gx = ctx.adjoint(g)
        if ctx.needs_input_grad[0]:
            gvals = g[:, None] * x[cols.long()]
        return gvals, gx, None, None, None


def ell_matvec(vals, cols, x, layout=None, adjoint=None):
    """y (n,) = ELL (vals, cols) (n, K) times x (ncols,).

    vals float32 or float64, x of the same dtype, cols int32 with every entry
    in [0, ncols) (``ELLMatrix.from_numpy`` checks that once), all
    contiguous and on one device.  ``layout`` is ``prepare_ell`` of this
    table; without it a CUDA call builds a throwaway one (counted in
    ``layouts_built``).  Tensors on a card go to the kernel, others to
    ``ell_matvec_plain`` (a layout given there is checked, not used).
    With grad mode on and ``vals`` or ``x`` requiring a gradient the
    product is ``EllMatvec``, whose backward applies ``adjoint`` (default:
    the product of ``transpose_ell`` of the table, built in the backward).
    A numpy (or list) ``x`` becomes a tensor on the device and in the dtype
    of ``vals`` first.
    """
    x = as_input(x, vals)
    _check(vals, cols, x)
    if torch.is_grad_enabled() and (vals.requires_grad or x.requires_grad):
        if adjoint is None:
            ncols = x.shape[0]

            def adjoint(g):
                vt, ct = transpose_ell(vals.detach(), cols, ncols)
                return ell_matvec(vt, ct, g)

        return EllMatvec.apply(vals, x, cols, layout, adjoint)
    return _ell_matvec(vals, cols, x, layout)


def _ell_matvec(vals, cols, x, layout):
    """``ell_matvec`` on checked inputs, no autograd: the product's one
    device branch, the kernel on a card, ``ell_matvec_plain`` elsewhere."""
    global launches
    if layout is not None and (layout.n != vals.shape[0]
                               or layout.dtype != vals.dtype
                               or layout.device != vals.device
                               or layout.ncols != x.shape[0]):
        raise ValueError(f"layout ({layout.n} rows, x of {layout.ncols}, "
                         f"{layout.dtype} on {layout.device}) does not fit "
                         f"vals {tuple(vals.shape)} {vals.dtype} on "
                         f"{vals.device} and x of {x.shape[0]}")
    if not on_card(x):
        return ell_matvec_plain(vals, cols, x)
    n = vals.shape[0]
    y = torch.empty(n, dtype=vals.dtype, device=vals.device)
    if n == 0:
        return y
    if layout is None:
        layout = prepare_ell(vals, cols, x.shape[0])
    L = layout
    LIB.launch(vals.dtype, x, L.vals.data_ptr(), L.cols.data_ptr(),
               L.slice_ptr.data_ptr(), L.slice_K.data_ptr(), L.rows.data_ptr(),
               x.data_ptr(), y.data_ptr(), n, L.nslices)
    launches += 1
    return y
