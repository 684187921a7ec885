"""Nitsche-XFEM interface Poisson (enrichment-space formulation).

Counterpart of ``examples/nxfem.py`` (the reference tutorial
``py_tutorials/nxfem.py``): standard space + XFESpace enrichment,
Hansbo-averaged Nitsche coupling.  With ``deform=True`` the isoparametric
mesh adaptation deforms the mesh: ``system`` sets the deformation on the mesh
after the Dirichlet data (as the JAX example does before assembling), and
``run`` unsets it after the L2 error.

Run: ``python -m ngsxfem_tpu_torch.examples.nxfem``.
"""
from ngsxfem_tpu_torch import *
from ngsxfem_tpu_torch.examples.cutfem import manufactured_interface_problem


def system(nx=15, order=1, mesh=None, device=None, deform=False):
    """The weak forms of the workload, not yet assembled: ``(a, f, VhG,
    freedofs, l2error, gfu)`` with ``gfu`` a GridFunction on ``VhG`` that
    holds the Dirichlet data (the solve adds the update to it) and
    ``l2error(gfu)`` the L2 error over both subdomains.  With ``deform``
    the mesh holds the isoparametric deformation on return."""
    if mesh is None:
        mesh = MakeStructured2DMesh(
            quads=False, nx=nx, ny=nx,
            mapping=lambda a, b: (3 * a - 1.5, 3 * b - 1.5)
        )

    solution, coef_f, alpha, levelset = manufactured_interface_problem()

    deformation = None
    if deform:
        lsetadap = LevelSetMeshAdaptation(mesh, order=order, threshold=1000,
                                          device=device)
        deformation = lsetadap.CalcDeformation(levelset)
        lsetp1 = lsetadap.lset_p1
    else:
        lsetp1 = GridFunction(H1(mesh, order=1, device=device))
        InterpolateToP1(levelset, lsetp1)

    Vh = H1(mesh, order=order, dirichlet=[1, 2, 3, 4], device=device)
    Vhx = XFESpace(Vh, lsetp1)
    VhG = FESpace([Vh, Vhx])

    n = 1.0 / grad(lsetp1).Norm() * grad(lsetp1)
    h = specialcf.mesh_size
    kappa = [CutRatioGF(Vhx.GetCutInfo()), 1.0 - CutRatioGF(Vhx.GetCutInfo())]
    stab = 10 * (alpha[1] + alpha[0]) * (order + 1) * order / h

    u_std, u_x = VhG.TrialFunction()
    v_std, v_x = VhG.TestFunction()

    u = [u_std + op(u_x) for op in [neg, pos]]
    v = [v_std + op(v_x) for op in [neg, pos]]
    gradu = [grad(u_std) + op(u_x) for op in [neg_grad, pos_grad]]
    gradv = [grad(v_std) + op(v_x) for op in [neg_grad, pos_grad]]

    average_flux_u = sum(-kappa[i] * alpha[i] * (gradu[i] * n) for i in [0, 1])
    average_flux_v = sum(-kappa[i] * alpha[i] * (gradv[i] * n) for i in [0, 1])

    lset_neg = {"levelset": lsetp1, "domain_type": NEG, "subdivlvl": 0}
    lset_pos = {"levelset": lsetp1, "domain_type": POS, "subdivlvl": 0}
    lset_if = {"levelset": lsetp1, "domain_type": IF, "subdivlvl": 0}

    a = BilinearForm(VhG, symmetric=True)
    a += SymbolicBFI(levelset_domain=lset_neg, form=alpha[0] * (gradu[0] * gradv[0]))
    a += SymbolicBFI(levelset_domain=lset_pos, form=alpha[1] * (gradu[1] * gradv[1]))
    a += SymbolicBFI(levelset_domain=lset_if, form=average_flux_u * (v[0] - v[1]))
    a += SymbolicBFI(levelset_domain=lset_if, form=average_flux_v * (u[0] - u[1]))
    a += SymbolicBFI(levelset_domain=lset_if, form=stab * (u[0] - u[1]) * (v[0] - v[1]))

    f = LinearForm(VhG)
    f += SymbolicLFI(levelset_domain=lset_neg, form=coef_f[0] * v[0])
    f += SymbolicLFI(levelset_domain=lset_pos, form=coef_f[1] * v[1])

    gfu = GridFunction(VhG)
    gfu.components[0].Set(solution[1], boundary=True)
    if deformation is not None:
        mesh.SetDeformation(deformation)

    def l2error(gfu):
        uh = [gfu.components[0] + op(gfu.components[1]) for op in [neg, pos]]
        err_sqr = [(uh[i] - solution[i]) * (uh[i] - solution[i]) for i in [0, 1]]
        return (
            Integrate(levelset_domain=lset_neg, cf=err_sqr[0], mesh=mesh, order=2 * order)
            + Integrate(levelset_domain=lset_pos, cf=err_sqr[1], mesh=mesh, order=2 * order)
        ) ** 0.5

    return a, f, VhG, VhG.FreeDofs(), l2error, gfu


def run(nx=15, order=1, verbose=True, deform=False, mesh=None, device=None):
    a, f, VhG, freedofs, error, gfu = system(nx, order, mesh, device, deform)
    try:
        a.Assemble()
        f.Assemble()

        rhs = f.vec.data - a.mat * gfu.vec.data
        update = a.mat.Inverse(freedofs) * rhs
        gfu.vec.data = gfu.vec.data + update

        l2error = error(gfu)
    finally:
        VhG.components[0].mesh.UnsetDeformation()
    if verbose:
        print("L2 error:", l2error)
    return l2error


if __name__ == "__main__":
    run()
