"""Static condensation: Schur-complement elimination of LOCAL dofs.

Counterpart of ``ngsxfem_tpu/solvers/condense.py``.  The reference gets this
from NGSolve's generic condensation machinery (the trace flag of XFESpace,
``xfem/xFESpace.cpp:72-97``, exists to mark outer-band face bubbles as
LOCAL_DOF for it).  Here condensation works on the assembled matrix, on the
host with scipy, as in the JAX package: the LOCAL block is factored sparsely
once (it is small and block-diagonal dominated), the coupled system is
solved by a Jacobi-preconditioned scipy CG on the Schur complement applied
through that factorization, and the local dofs are recovered by
back-substitution.  The matrix and the right-hand side come to the host for
it, and the solution goes back to the device of ``b``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import as_input, config


def condensed_solve(A, b, local_dofs, freedofs=None, solver=None):
    """Solve A x = b by eliminating ``local_dofs`` via a Schur complement.

    ``A``: SparseMatrix; ``b``: (n,) tensor (or a vector shim, or numpy);
    ``local_dofs``/``freedofs``: bool masks (BitArray or numpy).
    ``solver(mat_scipy, rhs) -> x`` solves the condensed coupled system,
    given the explicit Schur complement; the default is the CG above.
    Returns the full solution vector (local dofs recovered) on the device of
    ``b`` (of ``A`` for a numpy ``b``), in ``config.dtype``.
    """
    from scipy.sparse.linalg import splu

    b = as_input(b, device=A.vals.device)
    device = b.device
    n = A.shape[0]
    loc = np.asarray(local_dofs.np if hasattr(local_dofs, "np")
                     else local_dofs)
    free = (np.ones(n, bool) if freedofs is None
            else np.asarray(freedofs.np if hasattr(freedofs, "np")
                            else freedofs))
    loc = loc & free
    coup = free & ~loc
    bn = b.detach().cpu().numpy().astype(np.float64)

    S = A.to_scipy().tocsr()
    iL = np.nonzero(loc)[0]
    iC = np.nonzero(coup)[0]
    A_LL = S[iL][:, iL].tocsc()
    A_CL = S[iC][:, iL].tocsr()
    A_LC = S[iL][:, iC].tocsr()
    A_CC = S[iC][:, iC].tocsr()

    lu_LL = splu(A_LL.astype(np.float64))
    # Schur rhs: b_C - A_CL A_LL^{-1} b_L
    zL = lu_LL.solve(bn[iL]) if len(iL) else np.zeros(0)
    rhs = bn[iC] - (A_CL @ zL if len(iL) else 0.0)
    if solver is None:
        # the condensed operator A_CC - A_CL A_LL^{-1} A_LC, applied
        # through the LU
        from scipy.sparse.linalg import LinearOperator, cg as scipy_cg

        def mv(x):
            y = A_CC @ x
            if len(iL):
                y = y - A_CL @ lu_LL.solve(A_LC @ x)
            return y

        op = LinearOperator((len(iC), len(iC)), matvec=mv, dtype=np.float64)
        diag = np.maximum(np.abs(A_CC.diagonal()), 1e-30)
        M = LinearOperator((len(iC), len(iC)),
                           matvec=lambda r: r / diag, dtype=np.float64)
        xC, info = scipy_cg(op, rhs, rtol=1e-12, maxiter=20 * len(iC) + 100,
                            M=M)
        if info != 0:
            raise RuntimeError(f"condensed CG did not converge (info={info})")
    else:
        # a custom solver receives the explicit Schur complement (not just
        # A_CC: the correction term is what condensation is about), built
        # densely through the LU
        S_cc = A_CC
        if len(iL):
            from scipy.sparse import csr_matrix

            S_cc = A_CC - csr_matrix(A_CL @ lu_LL.solve(A_LC.toarray()))
        xC = solver(S_cc, rhs)

    out = np.zeros(n, dtype=np.float64)
    out[iC] = xC
    if len(iL):
        out[iL] = lu_LL.solve(bn[iL] - A_LC @ xC)
    return torch.as_tensor(out, dtype=config.dtype, device=device)
