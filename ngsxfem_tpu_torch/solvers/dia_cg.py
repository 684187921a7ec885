"""Fused fixed-budget Jacobi-PCG on the symmetric offset-diagonal operator.

Counterpart of ``ngsxfem_tpu/solvers/pallas_cg.py``.  On a CUDA tensor,
``dia_cg_fused`` runs the whole loop through the hand-written Hopper kernel
``csrc/dia_cg.cu`` (see the note at the top of that file for its design and
what bounds it); on a CPU tensor it runs ``dia_cg_fused_plain``, the same
algorithm in PyTorch.  There is no fallback between the two: a CUDA tensor
reaches the kernel or the call raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .krylov import _vdot

# calls of `dia_cg_fused` that went to the CUDA kernel (one per call, however
# many device kernels the call launches); read and reset by chip_smoke.py
launches = 0

_LIB = None


def _upper(offsets):
    """Host split of a symmetric offset set into (main-diag idx, [(idx, o>0)])."""
    offs = [int(o) for o in np.asarray(offsets).tolist()]
    if sorted(offs) != sorted(-o for o in offs):
        raise ValueError("DIA offset set is not symmetric; fused CG "
                         "requires a symmetric operator")
    k0 = offs.index(0)
    pos = [(k, o) for k, o in enumerate(offs) if o > 0]
    return k0, pos


def _terms(offsets):
    """The offsets in table order, each with the table row it reads: the
    main diagonal for 0, the positive-offset diagonal of |o| otherwise (a
    negative offset is applied as the transpose of its mirror)."""
    k0, pos = _upper(offsets)
    row = {o: k for k, o in pos}
    row[0] = k0
    return [(row[abs(int(o))], int(o)) for o in np.asarray(offsets).tolist()]


def _sym_dia_matvec(vals, terms, p):
    """y = A p with A symmetric, read from its main and upper diagonals only:
    A[i, i+o] = d_|o|[min(i, i+o)].  Terms are summed in table order, the
    order of `sparse.dia_matvec`, so on an exactly symmetric table the two
    agree bit for bit."""
    n = p.shape[0]
    y = torch.zeros_like(p)
    for k, o in terms:
        m = abs(o)
        if m >= n:
            continue
        d = vals[k]
        # in place on views of the fresh y
        if o > 0:
            y[:n - m] += d[:n - m] * p[m:]
        elif o < 0:
            y[m:] += d[:n - m] * p[:n - m]
        else:
            y += d * p
    return y


def dia_cg_fused_plain(offsets, vals, b, dinv, iters):
    """The kernel's algorithm in PyTorch: fixed-budget Jacobi-PCG, x0 = 0,
    on the upper-diagonal symmetric matvec, with the same alpha/beta guards
    and the same f64-accumulated dot products (`krylov._vdot`).  Returns
    (x, ||r||)."""
    terms = _terms(offsets)
    x = torch.zeros_like(b)
    r = b
    z = dinv * r
    p = z
    rz = _vdot(r, z)
    for _ in range(iters):
        Ap = _sym_dia_matvec(vals, terms, p)
        den = _vdot(p, Ap)
        alpha = rz / torch.where(den == 0, 1.0, den)
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        rz_new = _vdot(r, z)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz_new
    return x, torch.sqrt(_vdot(r, r))


def _lib():
    global _LIB
    if _LIB is None:
        from ..kernels.build import load

        lib = load("dia_cg")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.dia_cg_f32.restype = I
        lib.dia_cg_f32.argtypes = [P, I, I, P, P, P, P, I,
                                   P, P, P, P, P, P, P, P]
        lib.dia_cg_f32_num_partials.restype = I
        lib.dia_cg_f32_num_partials.argtypes = [I]
        lib.dia_cg_f32_error_string.restype = ctypes.c_char_p
        lib.dia_cg_f32_error_string.argtypes = [I]
        _LIB = lib
    return _LIB


def _dia_cg_cuda(terms, vals, b, dinv, iters):
    global launches
    lib = _lib()
    n = b.shape[0]
    rows = np.ascontiguousarray([k for k, _ in terms], dtype=np.int32)
    offs = np.ascontiguousarray([o for _, o in terms], dtype=np.int32)
    x = torch.empty_like(b)
    r, z, p, Ap = torch.empty((4, n), dtype=b.dtype, device=b.device)
    parts = torch.empty(lib.dia_cg_f32_num_partials(n), dtype=torch.float64,
                        device=b.device)
    scal = torch.empty(4, dtype=b.dtype, device=b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = lib.dia_cg_f32(
            vals.data_ptr(), n, len(terms), rows.ctypes.data,
            offs.ctypes.data, b.data_ptr(), dinv.data_ptr(), iters,
            x.data_ptr(), r.data_ptr(), z.data_ptr(), p.data_ptr(),
            Ap.data_ptr(), parts.data_ptr(), scal.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("dia_cg_f32 kernel launch failed: "
                           f"{lib.dia_cg_f32_error_string(err).decode()}")
    launches += 1
    return x, scal[3]


def dia_cg_fused(offsets, vals, b, dinv, iters):
    """Fixed-budget Jacobi-PCG with x0 = 0 on a symmetric DIA operator.

    offsets : host ints, the symmetric DIA offset set (from
        ``UnfittedPoisson.dia_structure()["offsets"]``)
    vals    : (n_off, n) diagonal table, exactly symmetric; only the main
        and the positive-offset diagonals are read
    b       : (n,) rhs; dinv : (n,) Jacobi inverse diagonal
    iters   : iteration count (matches ``krylov.cg(tol=0)``)

    Returns (x (n,), res_norm 0-d tensor), the contract of the reference
    ``pallas_cg.dia_cg_fused`` up to reduction-order roundoff.  The
    reference's ``plane`` argument, a TPU layout parameter, is gone: the
    kernel indexes flat.  CUDA tensors must be float32 (the kernel's type)
    and go to the kernel; CPU tensors run ``dia_cg_fused_plain`` in their
    own floating dtype.
    """
    terms = _terms(offsets)
    n_off = len(terms)
    if vals.dim() != 2 or vals.shape[0] != n_off:
        raise ValueError(f"vals must be ({n_off}, n), got {tuple(vals.shape)}")
    n = vals.shape[1]
    for name, t in (("b", b), ("dinv", dinv)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
    for name, t in (("vals", vals), ("b", b), ("dinv", dinv)):
        if t.device != b.device:
            raise ValueError(f"{name} is on {t.device}, b on {b.device}")
        if t.dtype != vals.dtype or not t.dtype.is_floating_point:
            raise ValueError(f"{name} has dtype {t.dtype}; all inputs must "
                             f"share one floating dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    iters = int(iters)
    if iters < 0:
        raise ValueError("iters must be >= 0")
    if b.device.type == "cpu":
        return dia_cg_fused_plain(offsets, vals, b, dinv, iters)
    if b.device.type != "cuda":
        raise ValueError(f"no dia_cg_fused kernel for device {b.device}")
    if vals.dtype != torch.float32:
        raise ValueError(f"the CUDA kernel takes float32, got {vals.dtype}")
    return _dia_cg_cuda(terms, vals, b, dinv, iters)
