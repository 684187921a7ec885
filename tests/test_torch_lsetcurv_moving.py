"""The isoparametric deformation of the PyTorch port under a moving level
set (the benchmark's ``fictdom3d-p2iso.moving``: unset the deformation,
``CalcDeformation`` at the new position, set it), on the CPU at nx <= 6:

- a second ``CalcDeformation`` after the sphere's centre moved gives
  bitwise the deformation of a fresh ``LevelSetMeshAdaptation`` there;
- at two positions the moving deformation matches the JAX package's to
  1e-12 absolute, the tolerance of ``tests/test_torch_lsetcurv.py``;
- under ``torch.profiler`` the spans ``LevelSetMeshAdaptation::
  CalcDeformation`` (child ``ProjectShift``) and ``FacetPatch::map``
  (inside ``BilinearForm::Assemble``) appear with their counters at the
  values the host knows, and no sync is counted in them.
"""
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu_torch.utils import timing

CENTRES = [(0.05, -0.1, 0.13), (-0.17, 0.2, 0.031)]


def _mesh(N, nx):
    return N.MakeStructured3DMesh(hexes=False, nx=nx, ny=nx, nz=nx,
                                  mapping=lambda a, b, c: (2 * a - 1,
                                                           2 * b - 1,
                                                           2 * c - 1))


def _sphere(N, centre):
    """The level set of the sphere R=0.7 around the Parameters ``centre``."""
    x, y, z = (N.x - centre[0], N.y - centre[1], N.z - centre[2])
    return N.sqrt(x * x + y * y + z * z) - 0.7


def _lsa(N, mesh, **kw):
    return N.LevelSetMeshAdaptation(mesh, order=2, threshold=0.2,
                                    discontinuous_qn=True, **kw)


def _moved(N, nx, kw):
    """The deformation vectors of one adaptation at each of ``CENTRES``,
    the centre moved by ``Parameter.Set`` and the mesh's deformation unset
    and set around each ``CalcDeformation``."""
    mesh = _mesh(N, nx)
    c = [N.Parameter(v) for v in (0.0, 0.0, 0.0)]
    lset = _sphere(N, c)
    lsa = _lsa(N, mesh, **kw)
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for centre in [(0.0, 0.0, 0.0)] + CENTRES:
            for p, v in zip(c, centre):
                p.Set(v)
            mesh.UnsetDeformation()
            mesh.SetDeformation(lsa.CalcDeformation(lset))
            gf = lsa.deform
            out.append(np.array(gf.vec.data if hasattr(gf.vec, "data")
                                else gf._arr))
    mesh.UnsetDeformation()
    return out[1:]


@pytest.mark.parametrize("nx", [4, 6])
def test_moved_deformation_is_a_fresh_ones(nx):
    moved = _moved(T, nx, {"device": "cpu"})
    for centre, d in zip(CENTRES, moved):
        mesh = _mesh(T, nx)
        lsa = _lsa(T, mesh, device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fresh = lsa.CalcDeformation(_sphere(T, centre))
        assert np.array_equal(d, fresh.vec.data.numpy()), centre
        assert np.abs(d).max() > 1e-3  # it moved something


def test_moved_deformation_matches_jax():
    port = _moved(T, 6, {"device": "cpu"})
    jax = _moved(J, 6, {})
    for a, b in zip(port, jax):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-12, np.abs(a - b).max()
    assert np.abs(port[0] - port[1]).max() > 1e-3  # the positions differ


def test_new_spans_and_counters():
    """One moving step through the forms at nx=4: the deformation's spans
    and the facet patch's, each where it is called, with the node count
    of the deformation space and the patch's Newton points, and no
    ``host_syncs`` counted in them."""
    mesh = _mesh(T, 4)
    c = [T.Parameter(v) for v in CENTRES[0]]
    lsa = _lsa(T, mesh, device="cpu")
    Vh = T.H1(mesh, order=2, dgjumps=True, device="cpu")
    timing.reset_trace()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with profile(activities=[ProfilerActivity.CPU]):
                mesh.SetDeformation(lsa.CalcDeformation(_sphere(T, c)))
                ci = T.CutInfo(mesh, lsa.lset_p1, device="cpu")
                facets = T.GetFacetsWithNeighborTypes(
                    mesh, a=ci.GetElementsOfType(T.HASNEG),
                    b=ci.GetElementsOfType(T.IF))
                u, v = Vh.TnT()
                a = T.BilinearForm(Vh)
                a += T.SymbolicFacetPatchBFI(
                    form=(u - u.Other()) * (v - v.Other()),
                    definedonelements=facets)
                a.Assemble()
        recs = timing.spans()
        totals = timing.counters()
    finally:
        timing.reset_trace()
        mesh.UnsetDeformation()
    by = {r["name"]: r for r in recs}
    parent = {r["name"]: (recs[r["parent"]]["name"] if r["parent"] >= 0
                          else None) for r in recs}
    assert parent["ProjectShift"] == "LevelSetMeshAdaptation::CalcDeformation"
    assert parent["FacetPatch::map"] == "BilinearForm::Assemble"
    nodes = lsa.deform_space.scalar.ndof
    assert nodes == 9 ** 3
    assert by["ProjectShift"]["counters"] == {"ProjectShift::nodes": nodes}
    nq = 36  # the degree-4 rule of the order-2 facet patch
    interior = mesh.facet2el_np[:, 1] >= 0  # a patch has two elements
    points = 2 * int((np.asarray(facets) & interior).sum()) * nq * 8
    assert points > 0
    assert by["FacetPatch::map"]["counters"] == {"FacetPatch::points":
                                                 points}
    assert totals["ProjectShift::nodes"] == nodes
    assert totals["FacetPatch::points"] == points
    assert "host_syncs" not in totals
    assert all(r["end_ns"] is not None for r in recs)
    assert torch.is_tensor(lsa.deform.vec.data)
