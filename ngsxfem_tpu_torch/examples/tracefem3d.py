"""TraceFEM: Laplace-Beltrami on an implicit sphere surface (3D).

Counterpart of ``examples/tracefem3d.py`` (the reference tutorial
``py_tutorials/tracefem3d.py``): H1 space with active dofs on cut elements,
tangential-gradient surface form on the IF rule, normal-diffusion volume
stabilization on the cut band, on the isoparametrically deformed mesh
(``deform=True``).  The band system is SPD, so on the card the default
``Inverse()`` runs Jacobi-CG.  ``system`` gives the unassembled forms.

Run: ``python -m ngsxfem_tpu_torch.examples.tracefem3d``.
"""
from math import pi

from ngsxfem_tpu_torch import *


def system(nx=8, order=2, deform=True, device=None):
    """The weak forms of the workload, not yet assembled: ``(a, f, VhG,
    freedofs, l2error)`` with ``l2error(gfu)`` the L2 error on the surface.
    With ``deform`` the mesh (``VhG.mesh``) holds the deformation on
    return."""
    mesh = MakeStructured3DMesh(
        hexes=False, nx=nx, ny=nx, nz=nx,
        mapping=lambda a, b, c: (2.82 * a - 1.41, 2.82 * b - 1.41,
                                 2.82 * c - 1.41),
    )
    levelset = sqrt(x * x + y * y + z * z) - 1

    deformation = None
    if deform:
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
    cf_IF = BitArrayCF(ba_IF, mesh)
    freedofs = VhG.FreeDofs()
    freedofs &= GetDofsOfElements(VhG, ba_IF)

    n = 1.0 / sqrt(InnerProduct(grad(lset_approx), grad(lset_approx))) \
        * grad(lset_approx)
    h = specialcf.mesh_size

    def Pmat(u):
        return u - (u * n) * n

    u, v = VhG.TnT()
    lset_if = {"levelset": lset_approx, "domain_type": IF, "subdivlvl": 0}

    diff_coeff = reac_coeff = 1
    a = BilinearForm(VhG, symmetric=True)
    a += SymbolicBFI(
        levelset_domain=lset_if,
        form=diff_coeff * (Pmat(grad(u)) * Pmat(grad(v))) + reac_coeff * u * v,
    )
    # normal-diffusion stabilization on the cut band (tracefem3d.py:91)
    a += SymbolicBFI(
        form=(diff_coeff / h + reac_coeff * h) * (cf_IF * (grad(u) * n))
        * (grad(v) * n),
        definedonelements=ba_IF,
    )

    f_coeff = (
        sin(pi * z) * (diff_coeff * pi * pi * (1 - z * z) + reac_coeff)
        + diff_coeff * cos(pi * z) * 2 * pi * z
    )
    f = LinearForm(VhG)
    f += SymbolicLFI(levelset_domain=lset_if, form=f_coeff * v,
                     definedonelements=ba_IF)

    exact = sin(pi * z)

    def l2error(gfu):
        return Integrate(
            levelset_domain=lset_if, cf=(gfu - exact) * (gfu - exact),
            mesh=mesh, order=2 * order,
        ) ** 0.5

    if deformation is not None:
        mesh.SetDeformation(deformation)
    return a, f, VhG, freedofs, l2error


def run(nx=8, order=2, verbose=True, deform=True, device=None):
    a, f, VhG, freedofs, error = system(nx, order, deform, device)
    try:
        a.Assemble()
        f.Assemble()
        gfu = GridFunction(VhG)
        gfu.vec.data = a.mat.Inverse(freedofs) * f.vec.data
        l2error = error(gfu)
    finally:
        VhG.mesh.UnsetDeformation()
    if verbose:
        print("l2error :", l2error)
    return l2error


if __name__ == "__main__":
    run()
