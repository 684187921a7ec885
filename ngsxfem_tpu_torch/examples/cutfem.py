"""2D unfitted Nitsche interface Poisson (CutFEM formulation).

Counterpart of ``examples/cutfem.py`` (the reference tutorial
``py_tutorials/cutfem.py``; Hansbo-Nitsche averaging).  With
``deform=True`` the isoparametric mesh adaptation (``LevelSetMeshAdaptation``)
deforms the mesh for the assembly and the error.

Run: ``python -m ngsxfem_tpu_torch.examples.cutfem``.
"""
from math import pi

from ngsxfem_tpu_torch import *


def manufactured_interface_problem():
    """Reference interface-Poisson data (||x||_4 interface at r=1,
    py_tutorials/cutfem.py:28-42): returns (solution, coef_f, alpha, levelset)."""
    r44 = x**4 + y**4
    r41 = sqrt(sqrt(r44))
    r4m3 = 1.0 / (r41 * r41 * r41)
    r66 = x**6 + y**6
    r22 = x * x + y * y
    solution = [1.0 + pi / 2.0 - sqrt(2.0) * cos(pi / 4.0 * r44), pi / 2.0 * r41]
    coef_f = [
        -1.0 * sqrt(2.0) * pi * (pi * cos(pi / 4 * r44) * r66 + 3 * sin(pi / 4 * r44) * r22),
        -2.0 * pi * 3 / 2 * r4m3 * (-(r66) / (r44) + r22),
    ]
    alpha = [1.0, 2.0]
    levelset = r41 - 1.0
    return solution, coef_f, alpha, levelset


def run(nx=30, order=1, verbose=True, deform=False, mesh=None, device=None):
    if mesh is None:
        mesh = MakeStructured2DMesh(
            quads=False, nx=nx, ny=nx,
            mapping=lambda xx, yy: (3 * xx - 1.5, 3 * yy - 1.5)
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
    VhG = FESpace([Vh, Vh])

    ci = CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(HASNEG)
    haspos = ci.GetElementsOfType(HASPOS)
    freedofs = VhG.FreeDofs()
    freedofs &= CompoundBitArray(
        [GetDofsOfElements(Vh, hasneg), GetDofsOfElements(Vh, haspos)]
    )

    n = 1.0 / grad(lsetp1).Norm() * grad(lsetp1)
    h = specialcf.mesh_size
    kappa = (CutRatioGF(ci), 1.0 - CutRatioGF(ci))
    stab = 20 * (alpha[1] + alpha[0]) * order * order / h

    u = VhG.TrialFunction()
    v = VhG.TestFunction()
    gradu = [grad(ui) for ui in u]
    gradv = [grad(vi) for vi in v]

    average_flux_u = sum(-kappa[i] * alpha[i] * (gradu[i] * n) for i in [0, 1])
    average_flux_v = sum(-kappa[i] * alpha[i] * (gradv[i] * n) for i in [0, 1])

    lset_neg = {"levelset": lsetp1, "domain_type": NEG, "subdivlvl": 0}
    lset_pos = {"levelset": lsetp1, "domain_type": POS, "subdivlvl": 0}
    lset_if = {"levelset": lsetp1, "domain_type": IF, "subdivlvl": 0}

    a = BilinearForm(VhG, symmetric=True)
    a += SymbolicBFI(levelset_domain=lset_neg, form=alpha[0] * (gradu[0] * gradv[0]))
    a += SymbolicBFI(levelset_domain=lset_pos, form=alpha[1] * (gradu[1] * gradv[1]))
    a += SymbolicBFI(
        levelset_domain=lset_if,
        form=average_flux_u * (v[0] - v[1])
        + average_flux_v * (u[0] - u[1])
        + stab * (u[0] - u[1]) * (v[0] - v[1]),
    )

    f = LinearForm(VhG)
    f += SymbolicLFI(levelset_domain=lset_neg, form=coef_f[0] * v[0])
    f += SymbolicLFI(levelset_domain=lset_pos, form=coef_f[1] * v[1])

    gfu = GridFunction(VhG)
    gfu.components[1].Set(solution[1], boundary=True)

    if deformation is not None:
        mesh.SetDeformation(deformation)
    try:
        a.Assemble()
        f.Assemble()

        rhs = f.vec.data - a.mat * gfu.vec.data
        update = a.mat.Inverse(freedofs) * rhs
        gfu.vec.data = gfu.vec.data + update

        err_sqr = [
            (gfu.components[i] - solution[i]) * (gfu.components[i] - solution[i])
            for i in [0, 1]
        ]
        l2error = (
            Integrate(levelset_domain=lset_neg, cf=err_sqr[0], mesh=mesh,
                      order=2 * order)
            + Integrate(levelset_domain=lset_pos, cf=err_sqr[1], mesh=mesh,
                        order=2 * order)
        ) ** 0.5
    finally:
        if deformation is not None:
            mesh.UnsetDeformation()
    if verbose:
        print("L2 error:", l2error)
    return l2error


if __name__ == "__main__":
    run()
