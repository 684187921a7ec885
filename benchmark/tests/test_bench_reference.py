"""The plain reference (``benchmark/reference``) against the port on the
CPU at nx <= 8: the same mesh, and through each configuration's driver the
same cut geometry, operator, load and solution.  The tests import the
port; the reference does not."""
import ast
import os
import warnings

import numpy as np
import pytest
import torch

from harness import registry
from harness.trace import Spans
from harness.traffic import Step
from reference import cutp1

CPU = torch.device("cpu")
CENTRES = [(0.0, 0.0, 0.0), (0.05, -0.1, 0.13), (-0.17, 0.2, 0.031)]


def sizes_of(config, **change):
    bench = registry.load_benchmark()
    sizes = registry.sizes(bench, config)
    return {**sizes, **change}


def drive(config, sizes, traffic, inputs, seed=7):
    """The driver's numbers for the steps ``inputs`` on the CPU."""
    drv = registry.driver(config)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        st = drv.setup(sizes, traffic, CPU)
        outs = [(inp, drv.step(st, inp, Spans(None))) for inp in inputs]
        return drv.compare(sizes, traffic, outs, drv.release(st), CPU, seed)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                assert m.split(".")[0] in ("__future__", "numpy", "torch",
                                        "warnings"), m


@pytest.mark.parametrize("nx", [4, 6])
def test_lattice_mesh_is_the_ports(nx):
    """Same vertices, the same tetrahedra as vertex sets, the same number
    of interior facets."""
    from ngsxfem_tpu_torch import MakeStructured3DMesh

    mesh = MakeStructured3DMesh(hexes=False, nx=nx, ny=nx, nz=nx)
    lat = cutp1.Lattice(nx, 0.0, 1.0, CPU)
    assert np.array_equal(lat.X.numpy(), mesh.vertices_np)
    ours = {tuple(sorted(t)) for t in lat.tets.tolist()}
    theirs = {tuple(sorted(t)) for t in mesh.elements_np.tolist()}
    assert ours == theirs
    assert lat.facets.shape[0] == int((mesh.facet2el_np[:, 1] >= 0).sum())


@pytest.mark.parametrize("centre", CENTRES)
def test_forms_driver_matches_reference(centre):
    sizes = sizes_of("fictdom3d-p1-forms", nx=6)
    steps = [Step(0, centre, (3.0, (1.0, -2.0, 0.5))),
             Step(1, (centre[1], centre[2], centre[0]), (6.0, (0, 0, 0)))]
    for r in drive("fictdom3d-p1-forms", sizes,
                   {"walk": {"step_h": 0.25, "box": 0.2}}, steps):
        assert r["geom"] == 0 and r["active"] == 0
        assert r["op"] < 1e-13 and r["load"] < 1e-13 and r["sol"] < 1e-10


def test_forms_driver_fixed_geometry_matches_reference():
    sizes = sizes_of("fictdom3d-p1-forms", nx=6, centre=[0.1, 0.0, -0.05])
    steps = [Step(k, (0.1, 0.0, -0.05), (1.0 + k, (k, -1.0, 2.0)))
             for k in range(3)]
    for r in drive("fictdom3d-p1-forms", sizes, {"walk": None}, steps):
        assert r["geom"] == 0 and r["active"] == 0
        assert r["op"] < 1e-13 and r["load"] < 1e-13 and r["sol"] < 1e-10


@pytest.mark.parametrize("centre", [(0.5, 0.5, 0.5), (0.53, 0.47, 0.51)])
def test_lattice_driver_matches_reference(centre):
    """The float32 table against the float64 reference: rounding of f32."""
    sizes = sizes_of("fictdom3d-p1-lattice", nx=8)
    steps = [Step(0, centre, (1.0, (0.0, 0.0, 0.0)))]
    for r in drive("fictdom3d-p1-lattice", sizes,
                   {"walk": {"step_h": 0.25, "box": 0.08}}, steps):
        assert r["geom"] == 0 and r["active"] == 0
        assert r["op"] < 5e-6 and r["sol"] < 1e-5


def test_lattice_model_in_float64_matches_reference():
    """The model's DIA table in float64 equals the reference's operator to
    rounding, the identity rows and the ghost-penalty band included."""
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
    from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

    nx = 8
    m = UnfittedPoisson(nx=nx, dim=3, order=1, dtype=torch.float64,
                        device="cpu")
    st = m.dia_structure()
    lat = cutp1.Lattice(nx, 0.0, 1.0, CPU)
    phi = torch.linalg.vector_norm(
        lat.X - torch.tensor([0.52, 0.46, 0.5], dtype=torch.float64),
        dim=1) - 0.4
    V, ncut = m.assemble_vals_lattice(m.vertices, phi, st)
    S = cutp1.assemble(lat, phi, 20.0, 0.1, (1.0, (0, 0, 0)),
                       identity_inactive=True)
    x = torch.rand(lat.nv, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(3))
    y, yr = dia_matvec(st["offsets"], V, x), S.matvec(x)
    assert float((y - yr).abs().max() / yr.abs().max()) < 1e-13
    assert int(ncut) == int(S.cut.sum())
    act = m.active_dof_mask(phi)[torch.as_tensor(st["perm_inv"])]
    assert torch.equal(act, S.active)


def test_lattice_driver_fixed_geometry_matches_reference():
    sizes = sizes_of("fictdom3d-p1-lattice", nx=8, centre=[0.48, 0.5, 0.53])
    steps = [Step(k, (0.48, 0.5, 0.53), (1.0 + k, (k, -1.0, 2.0)))
             for k in range(2)]
    for r in drive("fictdom3d-p1-lattice", sizes, {"walk": None}, steps):
        assert r["geom"] == 0 and r["active"] == 0
        assert r["op"] < 5e-6 and r["sol"] < 1e-5
