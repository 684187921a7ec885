"""Krylov solvers on tensors (matrix-free friendly).

Counterpart of ``ngsxfem_tpu/solvers/krylov.py:17-69,146-199``.  The
reference's ``lax.fori_loop``/``lax.while_loop`` become Python loops.  The
fixed-budget path (``tol=0``) reads nothing back to the host; the
tolerance path reads one scalar per iteration to test convergence.
"""
from __future__ import annotations

import torch


def _vdot(a, b):
    """Krylov inner product at full precision: accumulated in float64 from
    exact products and rounded once to the working dtype.

    The rounded result then does not depend on the order of the reduction,
    so the fused CUDA kernel (csrc/dia_cg.cu, which reduces the same way)
    and this plain path produce the same f32 iterates.  With plain f32
    reductions the two drifted apart by 9.4e-3 relative in 50 PCG iterations
    at nx=48 (measured on an H100): f32 PCG on the cut system amplifies
    reduction-order roundoff.
    """
    return torch.dot(a.double(), b.double()).to(a.dtype)


def cg(matvec, b, x0=None, M=None, maxiter=500, tol=1e-10):
    """Preconditioned conjugate gradients; returns (x, iters, res_norm).

    With ``tol=0`` the loop runs exactly ``maxiter`` iterations (the
    reference's fixed-budget ``fori_loop`` path).
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r

    r = b - matvec(x0)
    z = M(r)
    p = z
    rz = _vdot(r, z)
    x = x0
    bnorm = torch.sqrt(_vdot(b, b))
    atol2 = (tol * bnorm.clamp_min(1e-30)) ** 2

    k = 0
    while k < maxiter:
        if tol != 0 and not bool(_vdot(r, r) > atol2):
            break
        Ap = matvec(p)
        denom = _vdot(p, Ap)
        alpha = rz / torch.where(denom == 0, 1.0, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _vdot(r, z)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz_new
        k += 1
    return x, k, torch.sqrt(_vdot(r, r))


def cg_ir(matvec32, matvec64, b, M=None, outer=4, inner=120):
    """Mixed-precision iterative refinement: f32 inner PCG, f64 outer
    residual.

    Each outer step computes r = b - A x in f64, solves the correction system
    in f32 with ``inner`` fixed PCG iterations, and accumulates in f64.  The
    refinement is SAFEGUARDED as in the reference: a correction is applied
    only if it reduces the true f64 residual, and non-finite entries are
    zeroed first, so the returned residual is monotone and finite.

    `matvec32`/`matvec64` act on f32/f64 vectors; `M` is the f32
    preconditioner.  Returns (x (f64), res_norm (f64, TRUE residual)).
    """
    if M is None:
        M = lambda r: r
    b64 = b.to(torch.float64)
    x64 = torch.zeros_like(b64)
    r64 = b64
    rn = torch.linalg.vector_norm(r64)
    for _ in range(outer):
        scale = rn.clamp_min(1e-30)
        r32 = (r64 / scale).to(torch.float32)
        d, _, _ = cg(matvec32, r32, M=M, maxiter=inner, tol=0.0)
        d64 = d.to(torch.float64)
        d64 = torch.where(torch.isfinite(d64), d64, 0.0)
        x_c = x64 + scale * d64
        r_c = b64 - matvec64(x_c)
        rn_c = torch.linalg.vector_norm(r_c)
        accept = rn_c < rn  # False on NaN: rejects a poisoned correction
        x64 = torch.where(accept, x_c, x64)
        r64 = torch.where(accept, r_c, r64)
        rn = torch.where(accept, rn_c, rn)
    return x64, rn


def jacobi_preconditioner(diag, free_mask=None):
    inv = torch.where(diag.abs() > 1e-30, 1.0 / diag, 0.0)
    if free_mask is not None:
        inv = torch.where(free_mask, inv, 0.0)

    def M(r):
        return inv * r

    return M
