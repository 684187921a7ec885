"""shifted_eval: evaluate a GridFunction through a deformation composition.

Counterpart of ``ngsxfem_tpu/lsetcurv/shifted.py`` (the reference's
``DiffOpShiftedEval``, ``lsetcurving/shiftedevaluate.hpp:13-70``): the
value of gf at s(x) = psi_back^{-1}(psi_forth(x)), where psi_* = id + d_*
are mesh deformations.  Used to transfer solutions between differently
deformed meshes.  The point inversion is a batched fixed-iteration Newton
within the element (polynomial basis extension), like the reference's
same-element search (shiftedevaluate.cpp:68-95).
"""
from __future__ import annotations

import torch

from ..cf.coefficient import CF
from ..config import config
from ..fem.gridfunction import GridFunction, gf_ref_value_and_grad, gf_value
from ..mesh.mesh import det_and_inv, map_points


class ShiftedEvalCF(CF):
    def __init__(self, gf: GridFunction, back=None, forth=None, niter=6):
        self.gf = gf
        self.back = back  # deformation GF (psi_back - id) or None
        self.forth = forth
        self.niter = niter
        vd = getattr(gf.space, "vdim", 1)
        self.dims = () if vd == 1 else (vd,)

    def children(self):
        return (self.gf,)

    def _eval_pure(self, ctx):
        from ..cf.context import EvalCtx

        et = ctx.mesh.et
        xhat = ctx.ref_pts  # (E|1, Q, d)
        coords = ctx.elem_coords

        def disp(defgf, pts):
            val, gref = gf_ref_value_and_grad(defgf, ctx.elem_ids, pts)
            return val.to(ctx.dtype), gref.to(ctx.dtype)

        # target physical point: vertex map + forth displacement at xhat
        target, _ = map_points(et, coords, xhat)
        if self.forth is not None:
            target = target + disp(self.forth, xhat)[0]

        yhat = xhat
        for _ in range(self.niter):
            py, Jy = map_points(et, coords, yhat)
            if self.back is not None:
                db, gb = disp(self.back, yhat)
                py, Jy = py + db, Jy + gb
            _, Jinv = det_and_inv(Jy)
            # "eqg,eqdg->eqd"
            yhat = yhat + (Jinv * (target - py)[..., None, :]).sum(-1)

        # convergence check + fallback (reference DiffOpShiftedEval warns on
        # a non-converged point search, shiftedevaluate.cpp:68-95): points
        # where the fixed-iteration Newton did not reach tolerance revert to
        # the unshifted reference point — bounded O(deformation) error
        # instead of evaluating at a garbage location.
        py, Jy = map_points(et, coords, yhat)
        if self.back is not None:
            py = py + disp(self.back, yhat)[0]
        err = torch.linalg.vector_norm(target - py, dim=-1)
        detJ, _ = det_and_inv(Jy)
        h = detJ.abs() ** (1.0 / xhat.shape[-1])
        tol = 1e4 * torch.finfo(yhat.dtype).eps * h.clamp_min(1e-30)
        conv = err <= tol
        if config.newton_debug:
            from ..utils.diagnostics import emit_nonconverged

            emit_nonconverged("shifted_eval Newton", "the unshifted point",
                              (~conv).sum(), conv.numel())
        yhat = torch.where(conv[..., None], yhat, xhat)

        sub = EvalCtx(ctx.mesh, yhat, elem_ids=ctx.elem_ids, time=ctx.time)
        hook = getattr(self.gf.space, "gf_eval_hook", None)
        if hook is not None:
            return hook(self.gf, sub)
        return gf_value(self.gf, ctx.elem_ids, yhat)


def shifted_eval(gf, back=None, forth=None):
    """Evaluate gf at psi_back^{-1}(psi_forth(x)) (reference shifted_eval,
    lsetcurving/python_lsetcurving.cpp:243-321)."""
    return ShiftedEvalCF(gf, back=back, forth=forth)
