"""Differentiable unfitted FEM: gradient-based level-set shape optimization.

Counterpart of ``examples/levelset_shape_opt.py``.  Every step of the cut
quadrature is a differentiable torch op (the case-table decomposition is a
gather, the edge-cut points are smooth functions of the vertex level-set
values), so ``torch.autograd`` differentiates NEG-domain and interface
integrals with respect to the level-set values exactly: the derivative of
the *discrete* functional.

``run``: recover the radius of a circle whose enclosed area matches a
target by Newton's method on r -> area(r), with autograd supplying dA/dr
(the shape derivative, 2 pi r up to O(h^2) geometry error).
``compliance_sensitivity``: the compliance of the fictitious-domain Poisson
problem differentiated through the solve, whose system is an ELL table
solved by ``krylov.cg_implicit`` (every product through the ELL kernel on
the card, the gradient by the implicit function theorem).

Run: ``python -m ngsxfem_tpu_torch.examples.levelset_shape_opt``.
"""
import numpy as np
import torch

from ngsxfem_tpu_torch.config import resolve_device
from ngsxfem_tpu_torch.mesh.mesh import det_and_inv, map_points
from ngsxfem_tpu_torch.mesh.structured import MakeStructured2DMesh
from ngsxfem_tpu_torch.ops.scatter import ScatterPlan
from ngsxfem_tpu_torch.ops.straightcut import cut_rule_element, eps_guard


def _scalar(r, device):
    """``r`` as a 0-d f64 tensor on ``device`` (a tensor is kept, with its
    graph)."""
    if torch.is_tensor(r):
        return r.to(device=device, dtype=torch.float64)
    return torch.tensor(float(r), dtype=torch.float64, device=device)


def make_area_fn(nx=32, device=None):
    """area(r): the NEG area of the circle of radius r around (0.5, 0.5)
    on a trig mesh nx x nx of the unit square (f64), differentiable in r."""
    dev = resolve_device(device)
    mesh = MakeStructured2DMesh(quads=False, nx=nx, ny=nx)
    coords = torch.as_tensor(mesh.vertices_np[mesh.elements_np],
                             dtype=torch.float64, device=dev)
    elems = torch.as_tensor(mesh.elements_np, dtype=torch.int64, device=dev)
    vdist = torch.as_tensor(
        np.sqrt(((mesh.vertices_np - 0.5) ** 2).sum(1)), device=dev)

    def area(r):
        phi = vdist - _scalar(r, dev)   # level-set dofs (differentiable)
        vals = eps_guard(phi[elems])
        rule = cut_rule_element("trig", vals, 2)
        _, J = map_points("trig", coords, rule.pts)
        detJ, _ = det_and_inv(J)
        return torch.sum(rule.w * (rule.side == 0) * detJ.abs())

    return area


def run(nx=32, target_area=0.25, r0=0.2, steps=6, verbose=True, device=None):
    """Newton on area(r) = target_area from r0; returns (r, final area)."""
    dev = resolve_device(device)
    area = make_area_fn(nx, dev)
    r = r0
    for k in range(steps):
        rt = _scalar(r, dev).requires_grad_()
        a_t = area(rt)
        (g_t,) = torch.autograd.grad(a_t, rt)
        a, g = float(a_t.detach()), float(g_t)
        if verbose:
            print(f"step {k}: r={r:.6f} area={a:.6f} dA/dr={g:.4f} "
                  f"(2*pi*r={2 * np.pi * r:.4f})")
        r = r - (a - target_area) / g         # Newton on area(r) = target
    final = float(area(r))
    if verbose:
        r_exact = np.sqrt(target_area / np.pi)
        print(f"converged r={r:.6f} (exact {r_exact:.6f}), "
              f"area={final:.8f} (target {target_area})")
    return r, final


def compliance_sensitivity(nx=12, r0=0.33, device=None, tol=1e-12,
                           maxiter=None):
    """comp(r): the compliance b^T x of the fictitious-domain Poisson
    problem (P1 trigs nx x nx, the circle of radius r, Nitsche 20, load 1,
    identity rows on the inactive dofs), differentiable in r through the
    solve.  The element matrices and load vectors are summed in a fixed
    order (``ScatterPlan``), the matrices into an ELL table, and the system
    is solved by
    ``krylov.cg_implicit`` to ``tol`` (default ``maxiter``: 20 x the dofs).
    ``r0`` is the radius of the reference's signature (unused)."""
    from ngsxfem_tpu_torch.models.poisson import (UnfittedPoisson,
                                                  cut_poisson_elmats,
                                                  cut_poisson_rhs_elvecs)
    from ngsxfem_tpu_torch.solvers.krylov import cg_implicit
    from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix

    dev = resolve_device(device)
    m = UnfittedPoisson(nx=nx, dim=2, order=1, dtype=torch.float64,
                        device=dev)
    verts = m.mesh.vertices_np
    coords = torch.as_tensor(verts[m.mesh.elements_np], device=dev)
    elems = torch.as_tensor(m.mesh.elements_np, dtype=torch.int64,
                            device=dev)
    e2d = torch.as_tensor(m.el2dof, dtype=torch.int64, device=dev)
    vdist = torch.as_tensor(np.sqrt(((verts - 0.5) ** 2).sum(1)), device=dev)
    n = m.ndof
    st = m.ell_structure()
    cols = torch.as_tensor(st["ell_cols"], device=dev)
    plan = ScatterPlan(torch.as_tensor(st["elm_slots"], device=dev),
                       cols.numel())
    rhs_plan = ScatterPlan(e2d.reshape(-1), n)
    maxiter = 20 * n if maxiter is None else maxiter

    def compliance(r):
        vals = (vdist - _scalar(r, dev))[elems]
        A = cut_poisson_elmats("trig", 1, coords, vals, 20.0)
        fe = cut_poisson_rhs_elvecs(
            "trig", 1, coords, vals,
            lambda p: torch.ones(p.shape[:-1], dtype=p.dtype,
                                 device=p.device))
        b = rhs_plan.add(fe.reshape(-1))
        ad = torch.zeros(n, dtype=torch.bool, device=dev)
        ad[e2d[(vals < 0).any(1)].reshape(-1)] = True
        ell_vals = plan.add(A.reshape(-1)).reshape(cols.shape)
        E = ELLMatrix(cols, ell_vals, (n, n))

        def mv(xv):
            return torch.where(ad, E.matvec(xv), xv)

        bm = torch.where(ad, b, 0.0)
        x_sol = cg_implicit(mv, bm, (ell_vals,), tol=tol, maxiter=maxiter)
        return torch.dot(bm, x_sol)

    return compliance


if __name__ == "__main__":
    run()
    comp = compliance_sensitivity()
    r0 = 0.33
    rt = torch.tensor(r0, dtype=torch.float64, device=resolve_device(),
                      requires_grad=True)
    (dc,) = torch.autograd.grad(comp(rt), rt)
    eps = 1e-5
    fd = (float(comp(r0 + eps)) - float(comp(r0 - eps))) / (2 * eps)
    print(f"dC/dr autodiff {float(dc):.6e} vs FD {fd:.6e}")
