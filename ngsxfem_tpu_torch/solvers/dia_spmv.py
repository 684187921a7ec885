"""The offset-diagonal (DIA) product: ``y[r] = sum_k vals[k, r] * x[r + o_k]``.

``dia_matvec`` (``sparse.dia_matvec``) holds the product's one device
branch: on a card (``on_card``) one launch of the hand-written kernel
``csrc/dia_spmv.cu`` (``dia_spmv``; see the note at the top of its source,
no TPU counterpart: XLA fuses the reference's), elsewhere its plain twin
``dia_matvec_plain``.  ``check`` holds the inputs to what the kernel takes
and gives the offsets as the kernel's parameter struct, made once per
offset tuple and cached: the offsets travel by value in the launch, so a
call makes no copy to the card, reads nothing back and allocates only y.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..config import as_input
from ..kernels.launch import I64, PTR, Library, on_card
from ..utils.timing import count

# offsets the kernel takes (csrc/dia_spmv.cu kMaxTerms; B1's
# dia_cg.MAX_TERMS); the lattice tables have 27
MAX_TERMS = 32

# launches of the CUDA kernel (one per `dia_matvec` call on CUDA tensors with
# at least one row)
launches = 0

_PARAMS = {}  # the offsets' int64 bytes -> their _Offsets


class _Offsets(ctypes.Structure):
    """``DiaOffsets`` of ``csrc/dia_spmv.cu``."""
    _fields_ = [("off", ctypes.c_longlong * MAX_TERMS),
                ("count", ctypes.c_int)]


_SIG = (PTR, PTR, PTR, I64, _Offsets, PTR)
LIB = Library("dia_spmv", {torch.float32: ("dia_spmv_f32", _SIG),
                           torch.float64: ("dia_spmv_f64", _SIG)})


def dia_matvec(offsets, vals, x):
    """Offset-diagonal (DIA) SpMV: y[r] = sum_k vals[k, r] * x[r + o_k].

    `offsets` are host ints; entries off the right/left end of a diagonal
    read zero, so boundary rows need no masking.  ``vals`` and ``x`` may be
    numpy (``x`` then goes to the device and dtype of ``vals``).

    On a card this is one launch of ``dia_spmv``, which gives the bits of
    ``dia_matvec_plain`` (a NaN's payload aside) and counts
    ``dia_matvec::kernel``: the lattice tables have 27 offsets, the kernel
    takes up to ``MAX_TERMS`` (32), and it raises ``ValueError`` on more,
    on mixed or non-float dtypes, on a non-contiguous table or vector and
    on shapes that do not match.  With grad mode on and ``vals`` or ``x``
    requiring a gradient the product there is ``DiaMatvec``, whose forward
    and transposed products are kernel launches too.  Other tensors run
    ``dia_matvec_plain`` and count ``dia_matvec::eager``; autograd
    differentiates it as it is.
    """
    vals = as_input(vals, x if torch.is_tensor(x) else None)
    x = as_input(x, vals)
    if not (on_card(vals) or on_card(x)):
        count("dia_matvec::eager")
        return dia_matvec_plain(offsets, vals, x)
    if torch.is_grad_enabled() and (vals.requires_grad or x.requires_grad):
        y = DiaMatvec.apply(vals, x, offsets)
    else:
        y = dia_spmv(offsets, vals, x)
    count("dia_matvec::kernel")
    return y


def dia_matvec_plain(offsets, vals, x):
    """``dia_matvec`` in PyTorch: each diagonal contributes one static
    shifted slice of the zero-padded x, a multiply and an add, in table
    order (the first term is not added to 0)."""
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


class DiaMatvec(torch.autograd.Function):
    """``y = dia_matvec(offsets, vals, x)`` on a card under autograd.

    The forward is the kernel (``dia_spmv``).  The gradient of ``x`` is
    itself a DIA product, ``dia_matvec(-offsets, vals_T, g)`` with
    ``vals_T[k, c] = vals[k, c - o_k]`` (0 off the ends): one more launch.
    That of ``vals`` is ``g[r] * x[r + o_k]`` (0 off the ends).  Under
    ``create_graph`` both are differentiable again."""

    @staticmethod
    def forward(ctx, vals, x, offsets):
        ctx.save_for_backward(vals, x)
        ctx.offsets = [int(o) for o in np.asarray(offsets).tolist()]
        return dia_spmv(offsets, vals, x)

    @staticmethod
    def backward(ctx, g):
        vals, x = ctx.saved_tensors
        offs = ctx.offsets
        g = g.contiguous()
        gvals = gx = None
        if ctx.needs_input_grad[1]:
            gx = dia_matvec([-o for o in offs], _shifted(vals, offs, -1), g)
        if ctx.needs_input_grad[0]:
            gvals = g * _shifted(x, offs, 1)
        return gvals, gx, None


def _shifted(t, offs, sign):
    """(len(offs), n): row k is ``t[k]`` (``t`` itself if it is a vector)
    read at ``c + sign * o_k``, 0 off the ends: one pad and one stack."""
    n = t.shape[-1]
    m = max(abs(o) for o in offs)
    tp = F.pad(t, (m, m))
    rows = [tp if t.dim() == 1 else tp[k] for k in range(len(offs))]
    return torch.stack([r[m + sign * o:m + sign * o + n]
                        for r, o in zip(rows, offs)])


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
    if vals.dtype not in LIB.entries or x.dtype != vals.dtype:
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


def dia_spmv(offsets, vals, x):
    """``y[r] = sum_k vals[k, r] * x[r + o_k]`` on CUDA tensors, one launch
    on the current stream, the bits of ``dia_matvec_plain`` (a NaN's
    payload aside).  No autograd (``DiaMatvec`` adds it).  Raises
    ``ValueError`` on inputs the kernel does not take (``check``)."""
    global launches
    params = check(offsets, vals, x)
    y = torch.empty_like(x)
    n = x.shape[0]
    if n == 0:
        return y
    LIB.launch(x.dtype, x, vals.data_ptr(), x.data_ptr(), y.data_ptr(), n,
               params)
    launches += 1
    return y
