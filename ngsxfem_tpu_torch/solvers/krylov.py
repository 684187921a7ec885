"""Krylov solvers on tensors (matrix-free friendly).

Counterpart of ``ngsxfem_tpu/solvers/krylov.py``.  The reference's
``lax.fori_loop``/``lax.while_loop`` become Python loops.  The fixed-budget
path of ``cg`` (``tol=0``) reads nothing back to the host; the tolerance
paths of ``cg`` and ``minres`` read one scalar per iteration to test
convergence.  Every function takes numpy (or a list) where it takes a
tensor, as the reference's ``jnp`` ops do, and converts it once at its
entry (``config.as_input``): onto the device and dtype of the operator
behind a bound ``matvec`` or of ``x0``, else the current card.
"""
from __future__ import annotations

import torch

from ..config import as_input
from ..utils.timing import count, traced


def _owner(f):
    """The operator behind a bound ``matvec`` (its matrix), else None."""
    return getattr(f, "__self__", None)


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


@traced("cg")
def cg(matvec, b, x0=None, M=None, maxiter=500, tol=1e-10, dot=None):
    """Preconditioned conjugate gradients; returns (x, iters, res_norm).

    With ``tol=0`` the loop runs exactly ``maxiter`` iterations (the
    reference's fixed-budget ``fori_loop`` path).  ``dot`` replaces the
    inner product (``_vdot``): a sharded vector's all-reduced one
    (``LatticeShard.dot``), so every rank takes the same branches.
    """
    b = as_input(b, x0 if torch.is_tensor(x0) else _owner(matvec))
    x0 = torch.zeros_like(b) if x0 is None else as_input(x0, b)
    if M is None:
        M = lambda r: r
    vdot = dot or _vdot

    r = b - matvec(x0)
    z = M(r)
    p = z
    rz = vdot(r, z)
    x = x0
    bnorm = torch.sqrt(vdot(b, b))
    atol2 = (tol * bnorm.clamp_min(1e-30)) ** 2

    k = 0
    while k < maxiter:
        if tol != 0 and not bool(vdot(r, r) > atol2):
            break
        Ap = matvec(p)
        denom = vdot(p, Ap)
        alpha = rz / torch.where(denom == 0, 1.0, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = vdot(r, z)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz_new
        k += 1
    count("cg::iterations", k)
    return x, k, torch.sqrt(vdot(r, r))


class _ImplicitCG(torch.autograd.Function):
    """The solve ``x = A(params)^-1 b`` of ``cg_implicit``, differentiated
    by the implicit function theorem."""

    @staticmethod
    def forward(ctx, b, solve, matvec, *params):
        x = solve(b)
        ctx.save_for_backward(x, *params)
        ctx.solve, ctx.matvec = solve, matvec
        return x

    @staticmethod
    def backward(ctx, g):
        x, *saved = ctx.saved_tensors
        lam = ctx.solve(g.contiguous())
        params = [p for p, need in zip(saved, ctx.needs_input_grad[3:])
                  if need]
        grads = iter(())
        if params:
            with torch.enable_grad():
                y = ctx.matvec(x.detach())
                grads = iter(torch.autograd.grad(y, params, grad_outputs=-lam,
                                                 allow_unused=True))
        out = [next(grads) if need else None
               for need in ctx.needs_input_grad[3:]]
        return (lam if ctx.needs_input_grad[0] else None, None, None, *out)


def cg_implicit(matvec, b, params=(), M=None, tol=1e-12, maxiter=10000):
    """x = A^-1 b by preconditioned CG to ``tol`` (relative residual),
    differentiable in ``b`` and in the tensors ``params`` that ``matvec``
    reads (the values of A): the counterpart of the gradient rule of
    ``jax.scipy.sparse.linalg.cg`` (a symmetric ``custom_linear_solve``).

    ``matvec`` is a callable or a matrix with a ``matvec`` (an
    ``ELLMatrix``: its products, and so both solves, through the ELL kernel
    on the card); A must be symmetric positive definite.  The
    backward solves ``A lam = g`` by the same CG and returns ``grad_b =
    lam`` and ``grad_params = -d(lam^T A(params) x)/d(params)`` through
    ``torch.autograd.grad`` of one product.  ``M`` (a callable, taken as
    constant) preconditions both solves.  Raises ``RuntimeError`` when a
    solve misses ``tol`` in ``maxiter`` iterations."""
    matvec = getattr(matvec, "matvec", matvec)
    params = tuple(params)

    def solve(rhs):
        with torch.no_grad():
            x, k, res = cg(matvec, rhs, M=M, maxiter=maxiter, tol=tol)
            bn = torch.sqrt(_vdot(rhs, rhs))
            if not bool(res <= tol * bn.clamp_min(1e-30)):
                raise RuntimeError(
                    f"cg_implicit: CG reached a relative residual of "
                    f"{float(res / bn.clamp_min(1e-30)):.3e}, not {tol:.0e}, "
                    f"in {k} iterations")
        return x

    return _ImplicitCG.apply(b, solve, matvec, *params)


def minres(matvec, b, x0=None, M=None, maxiter=500, tol=1e-10):
    """Preconditioned MINRES (Paige-Saunders) for symmetric indefinite
    systems; returns (x, iters, rel_res_estimate).

    ``M`` must be symmetric positive definite (it defines the Lanczos inner
    product).  Dots go through ``_vdot``; the loop reads the residual
    estimate ``phibar`` once per iteration to stop."""
    b = as_input(b, x0 if torch.is_tensor(x0) else _owner(matvec))
    x0 = torch.zeros_like(b) if x0 is None else as_input(x0, b)
    if M is None:
        M = lambda r: r
    eps = torch.finfo(b.dtype).eps
    r1 = b - matvec(x0)
    y = M(r1)
    beta1 = torch.sqrt(_vdot(r1, y).clamp_min(0.0))
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    x, r2, w, w2 = x0, r1, torch.zeros_like(b), torch.zeros_like(b)
    oldb, beta, dbar, epsln, phibar = zero, beta1, zero, zero, beta1
    cs, sn = zero - 1.0, zero
    rtol = tol * float(beta1.clamp_min(1e-30))
    k = 0
    if not float(beta1) > 0:
        return x, k, phibar / beta1.clamp_min(1e-30)
    while k < maxiter and float(phibar) > rtol:
        s = 1.0 / torch.where(beta == 0, 1.0, beta)
        v = s * y
        y = matvec(v)
        if k > 0:  # three-term Lanczos: subtract the previous direction
            y = y - (beta / torch.where(oldb == 0, 1.0, oldb)) * r1
        alfa = _vdot(v, y)
        y = y - (alfa / torch.where(beta == 0, 1.0, beta)) * r2
        r1, r2 = r2, y
        y = M(r2)
        oldb = beta
        beta = torch.sqrt(_vdot(r2, y).clamp_min(0.0))
        # previous rotation applied to the new column of T
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.sqrt(gbar * gbar + beta * beta).clamp_min(eps)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        # solution update
        w1, w2 = w2, w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = x + phi * w
        k += 1
    return x, k, phibar / beta1.clamp_min(1e-30)


@traced("cg_ir")
def cg_ir(matvec32, matvec64, b, M=None, outer=4, inner=120, dot=None):
    """Mixed-precision iterative refinement: f32 inner PCG, f64 outer
    residual.

    Each outer step computes r = b - A x in f64, solves the correction system
    in f32 with ``inner`` fixed PCG iterations, and accumulates in f64.  The
    refinement is SAFEGUARDED as in the reference: a correction is applied
    only if it reduces the true f64 residual, and non-finite entries are
    zeroed first, so the returned residual is monotone and finite.

    `matvec32`/`matvec64` act on f32/f64 vectors; `M` is the f32
    preconditioner.  ``dot`` is the inner product of a sharded vector (see
    ``cg``): the norms and the inner PCG then run on it.  Returns
    (x (f64), res_norm (f64, TRUE residual)).
    """
    if M is None:
        M = lambda r: r
    if dot is None:
        norm = torch.linalg.vector_norm
    else:
        norm = lambda v: torch.sqrt(dot(v, v))
    op = _owner(matvec64)
    b64 = as_input(b, _owner(matvec32) if op is None else op).to(
        torch.float64)
    x64 = torch.zeros_like(b64)
    r64 = b64
    rn = norm(r64)
    for _ in range(outer):
        scale = rn.clamp_min(1e-30)
        r32 = (r64 / scale).to(torch.float32)
        d, _, _ = cg(matvec32, r32, M=M, maxiter=inner, tol=0.0, dot=dot)
        d64 = d.to(torch.float64)
        d64 = torch.where(torch.isfinite(d64), d64, 0.0)
        x_c = x64 + scale * d64
        r_c = b64 - matvec64(x_c)
        rn_c = norm(r_c)
        accept = rn_c < rn  # False on NaN: rejects a poisoned correction
        x64 = torch.where(accept, x_c, x64)
        r64 = torch.where(accept, r_c, r64)
        rn = torch.where(accept, rn_c, rn)
    return x64, rn


def jacobi_preconditioner(diag, free_mask=None):
    """``M(r) = r / diag`` where ``|diag| > 1e-30`` and on the free dofs,
    0 elsewhere."""
    mask = free_mask if torch.is_tensor(free_mask) else None
    diag = as_input(diag, mask)
    keep = diag.abs() > 1e-30
    if free_mask is not None:
        keep = keep & as_input(free_mask, diag, dtype=torch.bool)
    inv = torch.where(keep, 1.0 / diag, 0.0)

    def M(r):
        return inv * r

    return M


def masked_matvec(matvec, free_mask):
    """Project a matvec onto the free dofs: A' = P A P + (I - P)."""
    free_mask = as_input(free_mask, _owner(matvec), dtype=torch.bool)

    def mv(x):
        xp = torch.where(free_mask, x, 0.0)
        y = matvec(xp)
        return torch.where(free_mask, y, x)

    return mv


def _cg_ell(mat, b, free, maxiter, tol):
    """Jacobi-preconditioned CG on the free-dof block of ``mat`` (an
    ``ELLMatrix``: every product through its cached layout, the ELL kernel
    on the card), the bool tensor ``free`` masking the matvec, the
    preconditioner and ``b``.  Returns (x, iters, res_norm)."""
    return cg(masked_matvec(mat.matvec, free), torch.where(free, b, 0.0),
              M=jacobi_preconditioner(mat.diagonal(), free), maxiter=maxiter,
              tol=tol)


def _free_mask(freedofs, device):
    """Bool tensor on ``device`` from a BitArray, a numpy mask or a
    tensor."""
    from ..fem.space import _arr

    if torch.is_tensor(freedofs):
        return freedofs.to(device=device, dtype=torch.bool)
    return torch.as_tensor(_arr(freedofs), device=device)


class CGSolver:
    """NGSolve-flavoured wrapper: ``CGSolver(mat, pre) * rhs``.

    ``freedofs`` is a BitArray or a bool mask (numpy or tensor); ``rhs`` a
    tensor or a dof-vector shim (``f.vec``).  A matrix with an ELL view
    (``.ell()``: an ``ELLMatrix``, or a ``SparseMatrix`` through its cached
    one) and no ``pre`` takes ``_cg_ell``; anything else runs ``cg`` on the
    masked matvec."""

    def __init__(self, mat, pre=None, maxsteps=500, tol=1e-10, freedofs=None):
        self.mat = mat
        self.pre = pre
        self.maxsteps = maxsteps
        self.tol = tol
        self.freedofs = freedofs

    def __mul__(self, rhs):
        mat = self.mat
        has_ell = hasattr(mat, "ell")
        if has_ell:
            mat = mat.ell()
        b = as_input(rhs, mat)
        if has_ell and self.pre is None:
            fm = (_free_mask(self.freedofs, b.device)
                  if self.freedofs is not None
                  else torch.ones(mat.shape[0], dtype=torch.bool,
                                  device=b.device))
            x, _, _ = _cg_ell(mat, b, fm, self.maxsteps, self.tol)
            return x
        mv = mat.matvec if hasattr(mat, "matvec") else mat
        M = self.pre
        if self.freedofs is not None:
            fm = _free_mask(self.freedofs, b.device)
            mv = masked_matvec(mv, fm)
            b = torch.where(fm, b, 0.0)
        if M is None and hasattr(mat, "diagonal"):
            M = jacobi_preconditioner(mat.diagonal())
        x, _, _ = cg(mv, b, M=M, maxiter=self.maxsteps, tol=self.tol)
        return x


class MinResSolver:
    """NGSolve-flavoured wrapper: ``MinResSolver(mat, pre) * rhs``.

    The device iterative solve of symmetric indefinite saddle-point systems
    (cut Stokes), where the reference tutorials call the host direct
    ``mat.Inverse(freedofs)``.  A ``SparseMatrix`` is applied through its
    cached ELL view, so every product is ``ell_matvec`` on its layout (the
    ELL kernel on the card).  The default preconditioner is the SPD
    absolute-value Jacobi ``r / |diag|`` (identity on fixed dofs and zero
    diagonals): plain Jacobi is indefinite here (pressure and multiplier
    rows carry negative or zero diagonals) and would break the Lanczos
    inner product."""

    def __init__(self, mat, pre=None, maxsteps=2000, tol=1e-10,
                 freedofs=None):
        self.mat = mat
        self.pre = pre
        self.maxsteps = maxsteps
        self.tol = tol
        self.freedofs = freedofs

    def __mul__(self, rhs):
        mat = self.mat
        if hasattr(mat, "ell"):
            mat = mat.ell()
        b = as_input(rhs, mat)
        mv = mat.matvec if hasattr(mat, "matvec") else mat
        fm = (None if self.freedofs is None
              else _free_mask(self.freedofs, b.device))
        M = self.pre
        if M is None and hasattr(mat, "diagonal"):
            ad = mat.diagonal().abs()
            dinv = torch.where(ad > 1e-30, 1.0 / ad.clamp_min(1e-30), 1.0)
            if fm is not None:
                dinv = torch.where(fm, dinv, 1.0)
            M = lambda r: dinv * r
        if fm is not None:
            mv = masked_matvec(mv, fm)
            b = torch.where(fm, b, 0.0)
        x, _, _ = minres(mv, b, M=M, maxiter=self.maxsteps, tol=self.tol)
        return x
