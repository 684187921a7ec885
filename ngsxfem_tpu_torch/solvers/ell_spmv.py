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

On CPU tensors ``ell_matvec`` runs ``ell_matvec_plain`` on the ``(n, K)``
table, and no solver builds a layout there (``uses_layout``).
``sell_matvec_plain`` is the kernel's reference: its sum, in plain PyTorch.
There is no fallback between kernel and plain: a CUDA tensor reaches the
kernel or the call raises.
"""
from __future__ import annotations

import ctypes

import torch

# launches of the CUDA kernel (one per `ell_matvec` call on CUDA tensors with
# at least one row) and layouts made by `prepare_ell`; read and reset by
# chip_smoke.py
launches = 0
layouts_built = 0

SLICE = 32     # rows per slice: one warp of the kernel
WINDOW = 1024  # rows sorted by length inside windows of this many rows

_LIB = None
_FN = {torch.float32: "sell_spmv_f32", torch.float64: "sell_spmv_f64"}


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


def uses_layout(t):
    """Whether products on the device of tensor ``t`` run on a sliced
    layout: on a CUDA card.  The CPU sums the ``(n, K)`` table itself."""
    return t.is_cuda


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
    if vals.dtype not in _FN:
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


def _lib():
    global _LIB
    if _LIB is None:
        from ..kernels.build import load

        lib = load("ell_spmv")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in _FN.values():
            fn = getattr(lib, name)
            fn.restype = I
            fn.argtypes = [P, P, P, P, P, P, P, I, L, P]
        lib.ell_spmv_error_string.restype = ctypes.c_char_p
        lib.ell_spmv_error_string.argtypes = [I]
        lib.sell_spmv_kernel_info.restype = I
        lib.sell_spmv_kernel_info.argtypes = [P]
        _LIB = lib
    return _LIB


def kernel_info(device):
    """{dtype name: (registers per thread, static shared memory bytes, local
    memory bytes per thread)} of the two compiled kernels on ``device``."""
    lib = _lib()
    buf = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = lib.sell_spmv_kernel_info(ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError("sell_spmv_kernel_info failed: "
                           f"{lib.ell_spmv_error_string(err).decode()}")
    return {"float32": tuple(buf[0:3]), "float64": tuple(buf[3:6])}


def ell_matvec(vals, cols, x, layout=None):
    """y (n,) = ELL (vals, cols) (n, K) times x (ncols,).

    vals float32 or float64, x of the same dtype, cols int32 with every entry
    in [0, ncols) (``ELLMatrix.from_numpy`` checks that once), all
    contiguous and on one device.  ``layout`` is ``prepare_ell`` of this
    table; without it a CUDA call builds a throwaway one (counted in
    ``layouts_built``).  CUDA tensors go to the kernel, CPU tensors to
    ``ell_matvec_plain`` (a layout given there is checked, not used);
    anything else raises.
    """
    global launches
    _check(vals, cols, x)
    if layout is not None and (layout.n != vals.shape[0]
                               or layout.dtype != vals.dtype
                               or layout.device != vals.device
                               or layout.ncols != x.shape[0]):
        raise ValueError(f"layout ({layout.n} rows, x of {layout.ncols}, "
                         f"{layout.dtype} on {layout.device}) does not fit "
                         f"vals {tuple(vals.shape)} {vals.dtype} on "
                         f"{vals.device} and x of {x.shape[0]}")
    if x.device.type == "cpu":
        return ell_matvec_plain(vals, cols, x)
    if x.device.type != "cuda":
        raise ValueError(f"no ell_matvec kernel for device {x.device}")
    n = vals.shape[0]
    y = torch.empty(n, dtype=vals.dtype, device=vals.device)
    if n == 0:
        return y
    if layout is None:
        layout = prepare_ell(vals, cols, x.shape[0])
    lib = _lib()
    L = layout
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _FN[vals.dtype])(
            L.vals.data_ptr(), L.cols.data_ptr(), L.slice_ptr.data_ptr(),
            L.slice_K.data_ptr(), L.rows.data_ptr(), x.data_ptr(),
            y.data_ptr(), n, L.nslices, stream)
    if err != 0:
        raise RuntimeError("ell_spmv kernel launch failed: "
                           f"{lib.ell_spmv_error_string(err).decode()}")
    launches += 1
    return y
