"""The offset-diagonal (DIA) product as one launch of ``csrc/dia_spmv.cu``.

``sparse.dia_matvec`` sends CUDA tensors here (see the note at the top of
the kernel's source).  ``check`` holds the inputs to what the kernel takes
and gives the offsets as the kernel's parameter struct, made once per
offset tuple and cached: the offsets travel by value in the launch, so a
call makes no copy to the card, reads nothing back and allocates only y.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

# offsets the kernel takes (csrc/dia_spmv.cu kMaxTerms; B1's
# dia_cg.MAX_TERMS); the lattice tables have 27
MAX_TERMS = 32

# launches of the CUDA kernel (one per `dia_matvec` call on CUDA tensors with
# at least one row)
launches = 0

_LIB = None
_FN = {torch.float32: "dia_spmv_f32", torch.float64: "dia_spmv_f64"}
_ENTRY = {}   # dtype -> the C entry, once the library is loaded
_PARAMS = {}  # the offsets' int64 bytes -> their _Offsets


class _Offsets(ctypes.Structure):
    """``DiaOffsets`` of ``csrc/dia_spmv.cu``."""
    _fields_ = [("off", ctypes.c_longlong * MAX_TERMS),
                ("count", ctypes.c_int)]


def check(offsets, vals, x):
    """The kernel's parameter struct of ``offsets``, once ``vals`` and ``x``
    are what the kernel takes: one dtype, float32 or float64, on one device;
    ``vals`` 2-D and contiguous with a row per offset; ``x`` 1-D, contiguous,
    as long as a row; 1 to ``MAX_TERMS`` offsets.  Raises ``ValueError``
    otherwise.  It reads no device and runs on CPU tensors as well."""
    offs = np.asarray(offsets, dtype=np.int64)
    if offs.ndim != 1:
        raise ValueError(f"offsets must be 1-D, got shape {offs.shape}")
    key = offs.tobytes()
    params = _PARAMS.get(key)
    if params is None:
        if not 1 <= offs.size <= MAX_TERMS:
            raise ValueError(f"{offs.size} offsets; the dia_spmv kernel "
                             f"takes 1 to {MAX_TERMS}")
        params = _Offsets((ctypes.c_longlong * MAX_TERMS)(*offs.tolist()),
                          offs.size)
        _PARAMS[key] = params
    if vals.dtype not in _FN or x.dtype != vals.dtype:
        raise ValueError(f"dia_spmv takes vals and x of one dtype, float32 "
                         f"or float64; got {vals.dtype} and {x.dtype}")
    if vals.device != x.device:
        raise ValueError(f"vals on {vals.device} and x on {x.device}")
    if vals.dim() != 2 or vals.shape[0] != offs.size:
        raise ValueError(f"vals {tuple(vals.shape)} must be (n_offsets, n) "
                         f"with n_offsets = {offs.size}")
    if not vals.is_contiguous():
        raise ValueError("vals must be contiguous (row-major (n_offsets, n))")
    if x.dim() != 1 or x.shape[0] != vals.shape[1] or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous vector of {vals.shape[1]}, "
                         f"got shape {tuple(x.shape)}")
    return params


def _lib():
    global _LIB
    if _LIB is None:
        from ..kernels.build import load

        lib = load("dia_spmv")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for dtype, name in _FN.items():
            fn = _ENTRY[dtype] = getattr(lib, name)
            fn.restype = I
            fn.argtypes = [P, P, P, L, _Offsets, P]
        lib.dia_spmv_error_string.restype = ctypes.c_char_p
        lib.dia_spmv_error_string.argtypes = [I]
        _LIB = lib
    return _LIB


def dia_spmv(offsets, vals, x):
    """``y[r] = sum_k vals[k, r] * x[r + o_k]`` on CUDA tensors, one launch
    on the current stream, the bits of ``sparse.dia_matvec_plain`` (a NaN's
    payload aside).  No autograd (``sparse.DiaMatvec`` adds it).  Raises
    ``ValueError`` on inputs the kernel does not take (``check``)."""
    global launches
    params = check(offsets, vals, x)
    y = torch.empty_like(x)
    n = x.shape[0]
    if n == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _ENTRY[x.dtype](vals.data_ptr(), x.data_ptr(), y.data_ptr(), n,
                              params, stream)
    if err != 0:
        raise RuntimeError("dia_spmv kernel launch failed: "
                           f"{lib.dia_spmv_error_string(err).decode()}")
    launches += 1
    return y
