"""Level-set geometry zoo: isoparametric distance EOC under adaptive
refinement.

Counterpart of ``examples/lsetgeoms.py``, the reference demo
``lsetcurving/py_demos/lsetgeoms.py``: for each named zoo geometry
(``LevelsetExamples`` / ``BoundingBoxes``, the reference
``utils/utils.py:5-27``), a geometry-error-driven loop (order-2
isoparametric deformation by ``LevelSetMeshAdaptation.CalcDeformation``,
max-distance measurement, ``RefineAtLevelSet`` marking + tet bisection)
prints the distance convergence table.

Deviation from the reference demo: a space is built for one mesh, so the
adaptation object is rebuilt per refinement level instead of auto-updating
(the measured distances/EOCs are the deliverable, as in the reference).

Run: ``python -m ngsxfem_tpu_torch.examples.lsetgeoms``.
"""
import math

from ngsxfem_tpu_torch import *


def run(geoms=("cheese", "torus", "dziukelliott", "dziuk88", "sphere"),
        nref=3, maxh=1.0, order=2, verbose=True, device=None):
    results = {}
    for lsetgeom in geoms:
        box = BoundingBoxes[lsetgeom]
        lo, hi = box[:3], box[3:]
        n = [max(2, int(math.ceil((h - l) / maxh))) for l, h in zip(lo, hi)]
        mesh = MakeStructured3DMesh(
            hexes=False, nx=n[0], ny=n[1], nz=n[2],
            mapping=lambda a, b, c: (lo[0] + (hi[0] - lo[0]) * a,
                                     lo[1] + (hi[1] - lo[1]) * b,
                                     lo[2] + (hi[2] - lo[2]) * c))
        levelset = LevelsetExamples[lsetgeom]

        distances = []
        for reflevel in range(nref):
            if reflevel > 0:
                mesh.Refine()
            # rebuilt per level (a space is built for one mesh)
            lsetmeshadap = LevelSetMeshAdaptation(
                mesh, order=order, threshold=100, discontinuous_qn=True,
                device=device)
            lsetmeshadap.CalcDeformation(levelset)
            distances.append(lsetmeshadap.CalcMaxDistance(levelset))
            # refine cut elements for the next level
            RefineAtLevelSet(gf=lsetmeshadap.lset_p1)

        eoc = [math.log(distances[i - 1] / distances[i]) / math.log(2)
               for i in range(1, len(distances))]
        if verbose:
            print(f"[{lsetgeom}] ne(final)={mesh.ne}")
            print("distances = {}".format(distances))
            print("eoc = {}".format(eoc))
        results[lsetgeom] = (distances, eoc)
    return results


if __name__ == "__main__":
    run()
