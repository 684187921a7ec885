"""CutFEM geometric multigrid on the fictitious-domain Poisson problem.

Counterpart of ``examples/cutmg.py`` (the reference prototype
``python/cutmg.py``): a hierarchy of structured meshes, the cut Nitsche +
ghost-penalty system assembled on each level, ``MultiGridCL`` with a
``CutFemSmoother`` (damped Jacobi + interface-block CG) per level as the
preconditioner of CG on the masked fine system, beside Jacobi-CG.  Every
product of both solves goes through an ELL view (kernel B2 on the card).

Run: ``python -m ngsxfem_tpu_torch.examples.cutmg``.
"""
import time

import torch

from ngsxfem_tpu_torch import *
from ngsxfem_tpu_torch.config import resolve_device
from ngsxfem_tpu_torch.solvers.krylov import (cg, jacobi_preconditioner,
                                              masked_matvec)
from ngsxfem_tpu_torch.solvers.mg import prolongation_matrix


def build_level(mesh, order=1, device=None):
    r = (sqrt(x * x + y * y) if mesh.dim == 2
         else sqrt(x * x + y * y + z * z))
    levelset = r - 0.6
    lsetp1 = GridFunction(H1(mesh, order=1, device=device))
    InterpolateToP1(levelset, lsetp1)
    ci = CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(HASNEG)
    hasif = ci.GetElementsOfType(IF)
    Vh = H1(mesh, order=order, dgjumps=True, device=device)
    ba_facets = GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif)
    h = specialcf.mesh_size
    n_lset = 1.0 / Norm(grad(lsetp1)) * grad(lsetp1)
    u, v = Vh.TnT()
    lset_neg = {"levelset": lsetp1, "domain_type": NEG}
    lset_if = {"levelset": lsetp1, "domain_type": IF}
    a = BilinearForm(Vh)
    a += SymbolicBFI(lset_neg, form=grad(u) * grad(v), definedonelements=hasneg)
    a += SymbolicBFI(lset_if, form=-(grad(u) * n_lset) * v - (grad(v) * n_lset) * u
                     + 20.0 / h * u * v)
    a += SymbolicFacetPatchBFI(form=0.5 / (h * h) * (u - u.Other()) * (v - v.Other()),
                               definedonelements=ba_facets)
    a.Assemble()
    f = LinearForm(Vh)
    f += SymbolicLFI(lset_neg, form=CoefficientFunction(1.0) * v,
                     definedonelements=hasneg)
    f.Assemble()
    active = GetDofsOfElements(Vh, hasneg)
    if_dofs = GetDofsOfElements(Vh, hasif)
    return Vh, a.mat, f.vec.data, active, if_dofs


def _meshes(nx0, levels, dim):
    if dim == 2:
        return [MakeStructured2DMesh(quads=False, nx=nx0 * 2**l, ny=nx0 * 2**l,
                                     mapping=lambda a, b: (2 * a - 1, 2 * b - 1))
                for l in range(levels)]
    return [MakeStructured3DMesh(hexes=False, nx=nx0 * 2**l, ny=nx0 * 2**l,
                                 nz=nx0 * 2**l,
                                 mapping=lambda a, b, c:
                                 (2 * a - 1, 2 * b - 1, 2 * c - 1))
            for l in range(levels)]


def run(nx0=8, levels=3, order=1, verbose=True, dim=2, device=None,
        stats=None):
    """MG-CG and Jacobi-CG to 1e-8 on the masked fine system; returns
    (MG-CG iterations, Jacobi-CG iterations, ||x_mg - x_j||).  dim=3 runs
    the same V-cycle on a sphere cut out of a tet box (the reference
    prototype is 2D-only).  ``stats`` (a dict), if given, receives the host
    seconds of each setup stage (``setup_s``), the solver objects and the
    two solves as closures (``mgcg``, ``jcg``) for timing."""
    device = resolve_device(device)  # raises without a card unless asked

    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    setup = {}
    t0 = clock()
    meshes = _meshes(nx0, levels, dim)
    setup["meshes"] = clock() - t0
    spaces, mats, rhss, actives, ifdofs = [], [], [], [], []
    setup["levels"] = []
    for m in meshes:
        t0 = clock()
        Vh, A, b, act, ifd = build_level(m, order, device)
        spaces.append(Vh), mats.append(A), rhss.append(b)
        actives.append(act), ifdofs.append(ifd)
        setup["levels"].append(clock() - t0)

    t0 = clock()
    prols = [prolongation_matrix(spaces[l], spaces[l + 1],
                                 device=mats[0].vals.device)
             for l in range(levels - 1)]
    setup["prolongations"] = clock() - t0
    t0 = clock()
    for A in mats:
        A.ell()
    setup["to_ell"] = clock() - t0
    t0 = clock()
    smoothers = [None] + [
        CutFemSmoother(mats[l], freedofs=actives[l], if_dofs=ifdofs[l])
        for l in range(1, levels)
    ]
    setup["smoothers"] = clock() - t0
    t0 = clock()
    mgpre = MultiGridCL(mats, prols, smoothers, coarse_freedofs=actives[0])
    setup["multigrid"] = clock() - t0

    A = mats[-1]
    E = A.ell()
    b = rhss[-1]
    fm = torch.as_tensor(actives[-1].np, device=b.device)
    mv = masked_matvec(E.matvec, fm)
    bm = torch.where(fm, b, 0.0)

    def mgcg():
        return cg(mv, bm, M=lambda r: torch.where(fm, mgpre(r), r),
                  maxiter=100, tol=1e-8)

    def jcg():
        return cg(mv, bm, M=jacobi_preconditioner(E.diagonal(), fm),
                  maxiter=2000, tol=1e-8)

    x_mg, it_mg, res_mg = mgcg()
    x_j, it_j, res_j = jcg()
    diff = float(torch.linalg.vector_norm(x_mg - x_j))
    if verbose:
        print(f"MG-CG iters: {int(it_mg)} (res {float(res_mg):.2e}); "
              f"Jacobi-CG iters: {int(it_j)} (res {float(res_j):.2e})")
        print("solution diff:", diff)
    if stats is not None:
        stats.update(setup_s=setup, mgpre=mgpre, mats=mats, prols=prols,
                     smoothers=smoothers, mgcg=mgcg, jcg=jcg, x_mg=x_mg,
                     x_j=x_j, ndof=A.shape[0], nfree=int(fm.sum()))
    return int(it_mg), int(it_j), diff


if __name__ == "__main__":
    run()
