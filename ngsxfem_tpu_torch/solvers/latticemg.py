"""Lattice DIA geometric multigrid: the gather-free cut-MG V-cycle.

Counterpart of ``ngsxfem_tpu/solvers/latticemg.py`` (whole file but for its
Newton-Schulz branch, ``:148-170``).  Every level's operator is the
offset-diagonal (DIA) table of ``UnfittedPoisson.dia_structure`` and every
component of the V-cycle is gather-free:

* smoothing: damped Jacobi on the DIA operator (``sparse.dia_matvec``);
* interface correction: a fixed-iteration Jacobi-CG on the masked operator
  ``z -> m * A(m * z) + (1 - m) * z`` with ``m`` the interface-dof
  indicator (``krylov.cg`` with ``tol=0``: no host read);
* transfers: the vertex lattices nest (n1_f = 2 n1_c - 1), so prolongation
  is separable 1D linear interpolation per axis and restriction is its
  exact transpose;
* coarse solve: a dense inverse of the coarse DIA operator (identity rows
  on empty dofs), computed once by ``prepare`` in float64 on the device of
  the tables and stored at solve precision.

The reference has no Pallas kernel on this path, so it is plain PyTorch.
Its Newton-Schulz refinement of an f32 seed inverse exists because the TPU
has no f64 LU; a device with a native f64 factorization does not need it,
and ``force_ns=True`` raises ``NotImplementedError``.  For the same reason
``prepare_safe`` keeps the reference's guard on the coarse-inverse residual
but raises where the reference falls back to a float64 host inverse.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import as_input, config, resolve_device, torch_dtype
from .krylov import cg
from .sparse import dia_matvec


def _interp_axis(a, axis):
    """1D linear interpolation along ``axis``: size nc -> 2*nc - 1."""
    a = as_input(a).movedim(axis, 0)
    mid = 0.5 * (a[:-1] + a[1:])
    body = torch.stack([a[:-1], mid], dim=1)
    body = body.reshape((2 * (a.shape[0] - 1),) + tuple(a.shape[1:]))
    out = torch.cat([body, a[-1:]], dim=0)
    return out.movedim(0, axis)


def _restrict_axis(a, axis):
    """Exact transpose of :func:`_interp_axis`: size nf=2*nc-1 -> nc.

    Out of place: the halved odd entries are padded by one zero at either
    end and added to the even entries from the left and from the right."""
    a = as_input(a).movedim(axis, 0)
    ev = a[0::2]
    half = 0.5 * a[1::2]
    pad = (0, 0) * (a.dim() - 1)
    out = ev + F.pad(half, pad + (0, 1)) + F.pad(half, pad + (1, 0))
    return out.movedim(0, axis)


class LatticeDIAMG:
    """Functional cut-MG over nested vertex lattices with DIA operators.

    offsets_list : per-level DIA offset sets (host ints, coarse..fine)
    n1_list      : per-level lattice side (nx+1), must nest 2*nc-1 = nf
    dim          : lattice dimension (2 or 3)
    active_masks : per-level (n,) bool, active dofs in VERTEX-LEX order
                   (``model.active_dofs[dia_structure()["perm_inv"]]``);
                   corrections outside the active set are zeroed
    if_masks     : per-level (n,) bool interface-dof indicators (None to
                   skip); the masked-CG interface correction runs on levels
                   l > 0
    """

    def __init__(self, offsets_list, n1_list, dim=3, active_masks=None,
                 if_masks=None, nsmooth=2, damping=0.6, if_iters=8):
        self.offsets = [[int(o) for o in np.asarray(off).tolist()]
                        for off in offsets_list]
        self.n1 = [int(n) for n in n1_list]
        self.dim = int(dim)
        self.nlevels = len(self.offsets)
        if len(self.n1) != self.nlevels:
            raise ValueError("offsets_list and n1_list length mismatch")
        for l in range(1, self.nlevels):
            if self.n1[l] != 2 * self.n1[l - 1] - 1:
                raise ValueError(
                    f"lattices must nest: n1[{l}]={self.n1[l]} != "
                    f"2*{self.n1[l - 1]}-1")
        self.nsmooth = int(nsmooth)
        self.damping = float(damping)
        self.if_iters = int(if_iters)
        self.active_np = (None if active_masks is None else
                          [None if a is None else np.asarray(a, dtype=bool)
                           for a in active_masks])
        self.if_np = (None if if_masks is None else
                      [None if m is None else np.asarray(m, dtype=bool)
                       for m in if_masks])

    # -- parameter dict -----------------------------------------------------
    def params(self, vals_list, dtype=None, *, device=None):
        """Dict of tensors on ``device`` (the card unless the caller asks
        for the CPU): the tables at ``dtype``, the active masks as bool and
        the interface masks as 0/1 at ``dtype``."""
        dtype = torch_dtype(dtype) or config.dtype
        device = resolve_device(device)

        def t(a, dt):
            if torch.is_tensor(a):
                return a.to(device=device, dtype=dt)
            return torch.as_tensor(np.array(a), device=device).to(dt)

        p = {"vals": [t(v, dtype) for v in vals_list]}
        p["act"] = (None if self.active_np is None else
                    [None if a is None else t(a, torch.bool)
                     for a in self.active_np])
        p["if"] = (None if self.if_np is None else
                   [None if m is None else t(m, dtype)
                    for m in self.if_np])
        return p

    def prepare(self, params, force_ns=False):
        """Jacobi diagonals and the dense coarse inverse, on the device of
        the tables; call once per assembled hierarchy.  The inverse is
        computed in float64 (the coarse cut system's conditioning overwhelms
        an f32 factorization) and stored at solve precision.

        ``out["ainv0_res"]`` is ``max|I - A0 @ ainv0|`` at float64, before
        the cast to solve precision, so callers can detect a garbage
        inverse; :meth:`prepare_safe` raises when it is large."""
        if force_ns:
            raise NotImplementedError(
                "the Newton-Schulz coarse inverse is a workaround for "
                "devices without a float64 LU; this port inverts in "
                "float64 on the device (torch.linalg.inv)")
        out = dict(params)
        out["dinv"] = []
        for l in range(self.nlevels):
            k0 = self.offsets[l].index(0)
            d = params["vals"][l][k0]
            out["dinv"].append(torch.where(d.abs() > 1e-30, 1.0 / d, 1.0))
        V0 = params["vals"][0]
        n0 = V0.shape[1]
        A0 = torch.zeros((n0, n0), dtype=torch.float64, device=V0.device)
        for k, o in enumerate(self.offsets[0]):
            # one diagonal per offset: a strided view of A0, no scatter
            lo, hi = max(0, -o), min(n0, n0 - o)
            if hi > lo:
                A0.diagonal(o).add_(V0[k, lo:hi].double())
        A0 = 0.5 * (A0 + A0.T)
        d0 = torch.diagonal(A0)
        A0 = A0 + torch.diag((d0.abs() < 1e-30).double())
        X = torch.linalg.inv(A0)
        eye = torch.eye(n0, dtype=A0.dtype, device=A0.device)
        out["ainv0"] = X.to(V0.dtype)
        out["ainv0_res"] = (eye - A0 @ X).abs().max()
        return out

    def prepare_safe(self, params, res_tol=1e-3, force_ns=False):
        """Guarded :meth:`prepare`: reads back the coarse-inverse residual
        (one scalar) and raises ``RuntimeError`` if it is NaN or above
        ``res_tol``.

        The reference substitutes a float64 host inverse there, because its
        device inverse starts from a float32 seed.  Here the device inverse
        is already a float64 LU, and a host float64 LU of the same matrix is
        no better: a coarse system that fails the guard is too
        ill-conditioned (or not finite) for this preconditioner."""
        out = self.prepare(params, force_ns=force_ns)
        res = float(out["ainv0_res"])
        if not (np.isfinite(res) and res <= res_tol):
            raise RuntimeError(
                f"coarse inverse residual max|I - A0 X| = {res} exceeds "
                f"{res_tol}: the coarse system is singular, not finite or "
                "too ill-conditioned for a float64 inverse")
        return out

    # -- device pieces ------------------------------------------------------
    def _mv(self, params, l, x):
        return dia_matvec(self.offsets[l], params["vals"][l], x)

    def _smooth(self, params, l, x, b):
        for _ in range(self.nsmooth):
            r = b - self._mv(params, l, x)
            x = x + self.damping * params["dinv"][l] * r
        return x

    def _if_correct(self, params, l, x, b):
        m = None if params.get("if") is None else params["if"][l]
        if m is None or self.if_iters <= 0:
            return x
        r = (b - self._mv(params, l, x)) * m
        dinv = params["dinv"][l]
        mc = 1.0 - m
        mdinv = m * dinv + mc

        def mv(z):
            return m * self._mv(params, l, m * z) + mc * z

        z, _, _ = cg(mv, r, M=lambda s: mdinv * s,
                     maxiter=self.if_iters, tol=0.0)
        return x + m * z

    def _prolong(self, l, xc):
        """Level l-1 -> l: separable (tri)linear interpolation on the
        vertex lattice."""
        nc = self.n1[l - 1]
        a = xc.reshape((nc,) * self.dim)
        for ax in range(self.dim):
            a = _interp_axis(a, ax)
        return a.reshape(-1)

    def _restrict(self, l, rf):
        """Level l -> l-1: the exact transpose of :meth:`_prolong`."""
        nf = self.n1[l]
        a = rf.reshape((nf,) * self.dim)
        for ax in range(self.dim):
            a = _restrict_axis(a, ax)
        return a.reshape(-1)

    def _cycle(self, params, l, b):
        if l == 0:
            return torch.matmul(params["ainv0"], b)
        x = self._smooth(params, l, torch.zeros_like(b), b)
        x = self._if_correct(params, l, x, b)
        r = b - self._mv(params, l, x)
        rc = self._restrict(l, r)
        act = params.get("act")
        if act is not None and act[l - 1] is not None:
            rc = torch.where(act[l - 1], rc, 0.0)
        xc = self._cycle(params, l - 1, rc)
        corr = self._prolong(l, xc)
        if act is not None and act[l] is not None:
            corr = torch.where(act[l], corr, 0.0)
        x = x + corr
        x = self._if_correct(params, l, x, b)
        x = self._smooth(params, l, x, b)
        return x

    def apply(self, params, b):
        """One V-cycle: z ~ A^{-1} b (CG preconditioner)."""
        return self._cycle(params, self.nlevels - 1,
                           as_input(b, params["vals"][-1]))
