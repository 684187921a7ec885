"""Row-padded ELL SpMV: ``y[r] = sum_k vals[r, k] * x[cols[r, k]]``.

Counterpart of ``ngsxfem_tpu/solvers/sparse.py:131-194`` (``ELLMatrix.matvec``
and its Pallas kernel ``_matvec_pallas_impl``).  On CUDA tensors
``ell_matvec`` launches the hand-written Hopper kernel ``csrc/ell_spmv.cu``
(see the note at the top of that file for its design and what bounds it); on
CPU tensors it runs ``ell_matvec_plain``, the same sum in the same order.
There is no fallback between the two: a CUDA tensor reaches the kernel or
the call raises.
"""
from __future__ import annotations

import ctypes

import torch

# launches of the CUDA kernel (one per `ell_matvec` call on CUDA tensors with
# at least one row); read and reset by chip_smoke.py
launches = 0

_LIB = None
_FN = {torch.float32: "ell_spmv_f32", torch.float64: "ell_spmv_f64"}


def ell_matvec_plain(vals, cols, x):
    """The kernel's sum in PyTorch: ``y = 0; y = y + vals[:, k] *
    x[cols[:, k]]`` for k = 0..K-1, one rounding per product and per sum, so
    on the card it equals the kernel bit for bit.  (``torch.sum(vals *
    x[cols], 1)`` reduces in no fixed order.)  The products are formed in
    one pass, slot-major, and summed slot by slot."""
    prods = (vals * x[cols]).T.contiguous()  # (K, n)
    y = torch.zeros(vals.shape[0], dtype=vals.dtype, device=vals.device)
    for k in range(vals.shape[1]):
        y = y + prods[k]
    return y


def _lib():
    global _LIB
    if _LIB is None:
        from ..kernels.build import load

        lib = load("ell_spmv")
        P, I = ctypes.c_void_p, ctypes.c_int
        for name in _FN.values():
            fn = getattr(lib, name)
            fn.restype = I
            fn.argtypes = [P, P, P, P, I, I, P]
        lib.ell_spmv_error_string.restype = ctypes.c_char_p
        lib.ell_spmv_error_string.argtypes = [I]
        _LIB = lib
    return _LIB


def _check(vals, cols, x):
    if vals.dim() != 2 or cols.dim() != 2 or tuple(cols.shape) != tuple(vals.shape):
        raise ValueError(f"vals and cols must be (n, K) of one shape, got "
                         f"{tuple(vals.shape)} and {tuple(cols.shape)}")
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got {tuple(x.shape)}")
    if vals.dtype not in _FN or x.dtype != vals.dtype:
        raise ValueError(f"vals and x must share float32 or float64, got "
                         f"{vals.dtype} and {x.dtype}")
    if cols.dtype != torch.int32:
        raise ValueError(f"cols must be int32, got {cols.dtype}")
    if not (vals.device == cols.device == x.device):
        raise ValueError(f"vals on {vals.device}, cols on {cols.device}, "
                         f"x on {x.device}: all must share one device")
    for name, t in (("vals", vals), ("cols", cols), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ell_matvec(vals, cols, x):
    """y (n,) = ELL (vals, cols) (n, K) times x (ncols,).

    vals float32 or float64, x of the same dtype, cols int32 with every entry
    in [0, ncols) (``ELLMatrix.from_numpy`` checks that once), all
    contiguous and on one device.  CUDA tensors go to the kernel, CPU
    tensors to ``ell_matvec_plain``; anything else raises.
    """
    global launches
    _check(vals, cols, x)
    if x.device.type == "cpu":
        return ell_matvec_plain(vals, cols, x)
    if x.device.type != "cuda":
        raise ValueError(f"no ell_matvec kernel for device {x.device}")
    n, K = vals.shape
    y = torch.empty(n, dtype=vals.dtype, device=vals.device)
    if n == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _FN[vals.dtype])(vals.data_ptr(), cols.data_ptr(),
                                            x.data_ptr(), y.data_ptr(), n, K,
                                            stream)
    if err != 0:
        raise RuntimeError("ell_spmv kernel launch failed: "
                           f"{lib.ell_spmv_error_string(err).decode()}")
    launches += 1
    return y
