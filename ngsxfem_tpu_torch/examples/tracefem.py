"""TraceFEM: Laplace-Beltrami on an implicit circle (2D).

Counterpart of ``examples/tracefem.py`` (the reference tutorials
``py_tutorials/tracefem.py`` / ``traceconverg.py``): H1 space with active
dofs on cut elements, tangential-gradient surface form on the IF rule,
normal-diffusion volume stabilization on the cut band; manufactured solution
u = x + y on the unit circle (so u - lap_Gamma(u) = 2(x+y)).  Above order 1
the isoparametric deformation (``deform=True``) curves the band.  The band
system is SPD, so on the card the default ``Inverse()`` runs Jacobi-CG.

Run: ``python -m ngsxfem_tpu_torch.examples.tracefem``.
"""
from ngsxfem_tpu_torch import *


def run(nx=12, order=1, deform=True, verbose=True, device=None):
    mesh = MakeStructured2DMesh(
        quads=False, nx=nx, ny=nx,
        mapping=lambda a, b: (3 * a - 1.5, 3 * b - 1.5),
    )
    levelset = sqrt(x * x + y * y) - 1.0

    deformation = None
    if deform and order > 1:
        lsetmeshadap = LevelSetMeshAdaptation(mesh, order=order,
                                              threshold=1000, device=device)
        deformation = lsetmeshadap.CalcDeformation(levelset)
        lset_approx = lsetmeshadap.lset_p1
    else:
        lset_approx = GridFunction(H1(mesh, order=1, device=device))
        InterpolateToP1(levelset, lset_approx)

    VhG = H1(mesh, order=order, dirichlet=[], device=device)
    ci = CutInfo(mesh, lset_approx)
    ba_IF = ci.GetElementsOfType(IF)
    freedofs = VhG.FreeDofs()
    freedofs &= GetDofsOfElements(VhG, ba_IF)

    n = 1.0 / Norm(grad(lset_approx)) * grad(lset_approx)
    h = specialcf.mesh_size

    def P(u):
        return u - (u * n) * n

    u, v = VhG.TnT()
    lset_if = {"levelset": lset_approx, "domain_type": IF, "subdivlvl": 0}

    a = BilinearForm(VhG, symmetric=True)
    a += SymbolicBFI(levelset_domain=lset_if, form=P(grad(u)) * P(grad(v)) + u * v)
    # normal-diffusion stabilization on the band (tracefem.py:52-56)
    a += SymbolicBFI(form=1.0 / h * (grad(u) * n) * (grad(v) * n),
                     definedonelements=ba_IF)

    f = LinearForm(VhG)
    f += SymbolicLFI(levelset_domain=lset_if, form=2 * (x + y) * v,
                     definedonelements=ba_IF)

    if deformation is not None:
        mesh.SetDeformation(deformation)
    try:
        a.Assemble()
        f.Assemble()
        gfu = GridFunction(VhG)
        gfu.vec.data = a.mat.Inverse(freedofs) * f.vec.data

        exact = x + y
        l2err = Integrate(levelset_domain=lset_if,
                          cf=(gfu - exact) * (gfu - exact),
                          mesh=mesh, order=2 * order + 2) ** 0.5
    finally:
        mesh.UnsetDeformation()
    if verbose:
        print(f"tracefem 2D: nx={nx} order={order} L2(Gamma) err={l2err:.3e}")
    return l2err


def converg(order=1, levels=3, nx0=8, deform=True, verbose=True, device=None):
    """EOC study (traceconverg.py): L2(Gamma) errors under refinement."""
    import math

    errs = [run(nx0 * 2**l, order=order, deform=deform, verbose=verbose,
                device=device)
            for l in range(levels)]
    eocs = [math.log(errs[i] / errs[i + 1]) / math.log(2)
            for i in range(len(errs) - 1)]
    if verbose:
        print("errors:", errs, "eocs:", eocs)
    return errs, eocs


if __name__ == "__main__":
    converg(order=1)
    converg(order=2)
