"""Unfitted interface Poisson on unstructured meshes.

Counterpart of ``examples/unstructured_nxfem.py``: the reference's meshing
idiom verbatim (``py_tutorials/nxfem.py:24-27``):
``SplineGeometry().AddRectangle(...)`` + ``Mesh(geo.GenerateMesh(maxh))``
with the native 2D spline mesher (``mesh/splinegeom.py``), or the Delaunay
mesher ``MakeUnstructuredMesh``, optionally round-tripped through a Gmsh
v2.2 file; then the CutFEM Nitsche solve of ``examples.cutfem``, whose
default ``Inverse()`` runs Jacobi-CG through kernel B2 on the card.

Run: ``python -m ngsxfem_tpu_torch.examples.unstructured_nxfem
[--gmsh] [--delaunay]``.
"""
import os
import sys
import tempfile

from ngsxfem_tpu_torch import (MakeUnstructuredMesh, Mesh, ReadGmsh,
                               SplineGeometry, WriteGmsh)
from ngsxfem_tpu_torch.examples import cutfem


def make_mesh(npts=900, seed=5, via_gmsh=False, mesher="spline"):
    """The example's mesh: the spline mesher on [-1.5, 1.5]^2 at maxh 0.2,
    or the Delaunay mesher with ``npts`` interior points from ``seed``
    mapped there; ``via_gmsh`` writes it as a Gmsh file and reads it
    back."""
    if mesher == "spline":
        # py_tutorials/nxfem.py:24-27 verbatim
        square = SplineGeometry()
        square.AddRectangle([-1.5, -1.5], [1.5, 1.5], bc=1)
        mesh = Mesh(square.GenerateMesh(maxh=0.2, quad_dominated=False))
    else:
        mesh = MakeUnstructuredMesh(
            dim=2, npts=npts, seed=seed,
            mapping=lambda a, b: (3 * a - 1.5, 3 * b - 1.5))
    if via_gmsh:  # round-trip through the Gmsh v2.2 reader
        with tempfile.NamedTemporaryFile(suffix=".msh", delete=False) as f:
            path = f.name
        try:
            WriteGmsh(mesh, path)
            mesh = ReadGmsh(path)
        finally:
            os.unlink(path)
    return mesh


def run(npts=900, seed=5, via_gmsh=False, mesher="spline", verbose=True,
        device=None):
    mesh = make_mesh(npts, seed, via_gmsh, mesher)
    if verbose:
        print(f"mesh: {mesh} ({'gmsh round-trip' if via_gmsh else mesher})")
    return cutfem.run(order=1, verbose=verbose, mesh=mesh, device=device)


if __name__ == "__main__":
    err = run(via_gmsh="--gmsh" in sys.argv,
              mesher="delaunay" if "--delaunay" in sys.argv else "spline")
    print("L2 error:", err)
    assert err < 0.06
