"""Quadrature-EOC demos: curved vs uncurved integration, and quad meshes.

Counterpart of ``examples/integrate_curved.py``, the two reference
integration demos:

* ``lsetcurving/py_demos/integrate.py`` — circle area/perimeter on a trig
  mesh at high order: UNCURVED (P1 level set, straight-cut rule, O(h^2))
  vs CURVED (same rule under the isoparametric deformation, O(h^(k+1))),
  over uniform refinements.
* ``cutint/py_demos/area_of_a_circle_quads.py`` — the same circle-area
  EOC driven entirely on a QUAD mesh (multilinear tensor cut rules),
  starting from a single element, uniform 1->4 refinement.

Run: ``python -m ngsxfem_tpu_torch.examples.integrate_curved``.
"""
import math

from ngsxfem_tpu_torch import *


def run_curved(order=5, nref=4, nx0=8, verbose=True, device=None):
    """lsetcurving/py_demos/integrate.py: curved vs uncurved EOC."""
    r = 0.5
    referencevals = {POS: 4.0 - 0.25 * math.pi, NEG: 0.25 * math.pi,
                     IF: math.pi}
    errs_unc = {k: [] for k in (NEG, POS, IF)}
    errs_cur = {k: [] for k in (NEG, POS, IF)}
    for lvl in range(nref):
        nx = nx0 * 2 ** lvl
        mesh = MakeStructured2DMesh(
            quads=False, nx=nx, ny=nx,
            mapping=lambda a, b: (2 * a - 1, 2 * b - 1))
        levelset = sqrt(x * x + y * y) - r
        lsetmeshadap = LevelSetMeshAdaptation(mesh, order=order,
                                              threshold=0.2,
                                              discontinuous_qn=True,
                                              device=device)
        deformation = lsetmeshadap.CalcDeformation(levelset)
        lset_p1 = lsetmeshadap.lset_p1
        for key in (NEG, POS, IF):
            ld = {"levelset": lset_p1, "domain_type": key}
            i_unc = Integrate(ld, cf=CoefficientFunction(1.0), mesh=mesh,
                              order=order)
            i_cur = Integrate(ld, cf=CoefficientFunction(1.0), mesh=mesh,
                              order=order, deformation=deformation)
            errs_unc[key].append(abs(i_unc - referencevals[key]))
            errs_cur[key].append(abs(i_cur - referencevals[key]))
    if verbose:
        for key, name in ((NEG, "NEG"), (POS, "POS"), (IF, "IF")):
            print(f"uncurved {name}:", errs_unc[key])
            print(f"  curved {name}:", errs_cur[key])
    return errs_unc, errs_cur


def run_quads(order=2, nref=6, verbose=True, device=None):
    """cutint/py_demos/area_of_a_circle_quads.py: circle-area EOC on a pure
    QUAD mesh (multilinear tensor-product cut rules), from one element."""
    r = 0.6
    referencevals = {POS: 1 - math.pi * r * r / 4,
                     NEG: math.pi * r * r / 4,
                     IF: r * math.pi / 2}
    errors = {k: [] for k in (NEG, POS, IF)}
    mesh = MakeStructured2DMesh(quads=True, nx=1, ny=1)
    for lvl in range(nref):
        if lvl > 0:
            mesh.Refine()
        lset_approx = GridFunction(H1(mesh, order=1, device=device))
        InterpolateToP1(sqrt(x * x + y * y) - r, lset_approx)
        for key in (NEG, POS, IF):
            val = Integrate(
                levelset_domain={"levelset": lset_approx, "domain_type": key},
                cf=CoefficientFunction(1.0), mesh=mesh, order=order)
            errors[key].append(abs(val - referencevals[key]))
    if verbose:
        for key, name in ((NEG, "NEG"), (POS, "POS"), (IF, "IF")):
            eoc = [math.log(errors[key][i] / errors[key][i + 1]) / math.log(2)
                   for i in range(len(errors[key]) - 1)
                   if errors[key][i + 1] > 0]
            print(f"quad {name} errors:", errors[key])
            print(f"quad {name} eoc:", eoc)
    return errors


if __name__ == "__main__":
    run_curved()
    run_quads()
