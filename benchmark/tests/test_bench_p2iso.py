"""The order-2 isoparametric configuration ``fictdom3d-p2iso`` on the CPU at
nx = 6: its plain reference (``reference/isop2.py``) against the program
through the configuration's module, the control, the faults the comparison
has to catch, and the per-layer metrics of a traced run."""
import ast
import os
import warnings

import pytest
import torch

from conftest import copy_benchmark, run_on_cpu
from harness import judge, registry
from harness.trace import Spans
from harness.traffic import Generator, Step

CPU = torch.device("cpu")
CONFIG = "fictdom3d-p2iso"
CELL = "fictdom3d-p2iso.moving"
NX = 6
NEW_METRICS = ("deform_ms", "patch_map_ms", "shift_nodes_per_step")


def _sizes(**change):
    return {**registry.sizes(registry.load_benchmark(), CONFIG), "nx": NX,
            **change}


def _traffic():
    return registry.traffic(CELL)


def test_reference_imports_only_numpy_and_torch():
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "reference", "isop2.py")
    for node in ast.walk(ast.parse(open(path).read())):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom)
                else [])
        for m in mods:
            assert m.split(".")[0] in ("__future__", "numpy", "torch",
                                       "warnings"), m


def test_reference_nodes_are_the_ports():
    """The doubled lattice holds every order-2 dof of the port's mesh once,
    and the elements' nodes are the port's as sets."""
    import ngsxfem_tpu_torch as api
    from reference import isop2

    m = isop2.Mesh(NX, -1.0, 1.0, CPU)
    mesh = api.MakeStructured3DMesh(
        hexes=False, nx=NX, ny=NX, nz=NX,
        mapping=lambda a, b, c: (2 * a - 1, 2 * b - 1, 2 * c - 1))
    Vh = api.H1(mesh, order=2, device="cpu")
    assert Vh.ndof == m.nn == (2 * NX + 1) ** 3
    # the port's elements in the reference's order: cell-major, then path
    ne = m.ne
    by_order = torch.empty(ne, dtype=torch.int64)
    by_order[m.order_id] = torch.arange(ne)
    verts = torch.as_tensor(mesh.elements_np).long()
    assert torch.equal(m.tets[by_order], verts)


@pytest.mark.parametrize("centres", [
    [(0.0, 0.0, 0.0), (0.05, -0.1, 0.13)],
    [(-0.17, 0.2, 0.031), (0.2, 0.2, -0.2)]])
def test_program_matches_reference(centres):
    """The same cut, the same deformation, operator, load and solution: the
    marks exactly, the rest near rounding (the solution near the program's
    CG tolerance)."""
    sizes = _sizes()
    drv = registry.driver(CONFIG)
    inputs = [Step(i, c, (6.0, (0.0, 0.0, 0.0)))
              for i, c in enumerate(centres)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        st = drv.setup(sizes, _traffic(), CPU)
        outs = [(inp, drv.step(st, inp, Spans(None))) for inp in inputs]
        readings = drv.compare(sizes, _traffic(), outs, drv.release(st), CPU,
                               7)
    for r in readings:
        assert r["geom"] == 0 and r["active"] == 0, r
        assert r["deform"] < 1e-13 and r["op"] < 1e-13, r
        assert r["load"] < 1e-13 and r["sol"] < 1e-9, r


def test_control_fails_the_limits():
    sizes, traffic = _sizes(), _traffic()
    gen = Generator(traffic, sizes, 11)
    inputs = [next(gen) for _ in range(3)][1:]
    r = registry.driver(CONFIG).control(sizes, traffic, inputs, CPU, 11)
    ok, table = judge.verdict(judge.worst(r), traffic["limits"])
    assert not ok, table
    assert all(table[k][0] > table[k][1] for k in ("op", "load", "deform")), \
        table


def _unchanged(mp):
    """The deformation and with it the cut computed for the first step
    only."""
    from ngsxfem_tpu_torch.lsetcurv.lsetcurv import LevelSetMeshAdaptation

    orig = LevelSetMeshAdaptation.CalcDeformation
    done = []

    def calc(self, *a, **k):
        if not done:
            done.append(1)
            return orig(self, *a, **k)
        return self.deform
    mp.setattr(LevelSetMeshAdaptation, "CalcDeformation", calc)


def _altered(mp):
    from ngsxfem_tpu_torch.solvers.sparse import InverseMatrix

    def alter(x):
        x = x.clone()
        i = int(x.abs().argmax())
        x[i] = x[i] * 1.1
        return x
    orig = InverseMatrix.solve
    mp.setattr(InverseMatrix, "solve", lambda self, rhs: alter(orig(self,
                                                                    rhs)))


def _half_batches(mp):
    """Every other element batch of the bilinear form left out."""
    from ngsxfem_tpu_torch.forms.assemble import BilinearForm

    orig = BilinearForm._elmat_batches

    def batches(self):
        return (b for i, b in enumerate(orig(self)) if i % 2 == 0)
    mp.setattr(BilinearForm, "_elmat_batches", batches)


def _undeformed(mp):
    """The deformation computed but never set on the mesh."""
    from ngsxfem_tpu_torch.mesh.mesh import Mesh

    mp.setattr(Mesh, "SetDeformation", lambda self, d: None)


def _float32(mp):
    """The whole program in float32, through the card's ``Inverse()``
    branch and its Jacobi-CG (the float64 symmetry check would send a
    float32 table to the host LU)."""
    from ngsxfem_tpu_torch.config import config
    from ngsxfem_tpu_torch.solvers import sparse

    mp.setattr(config, "dtype", torch.float32)
    mp.setattr(sparse, "_on_card", lambda mat: True)
    mp.setattr(sparse, "spd_free_block", lambda ell, free: True)


@pytest.mark.parametrize("fault", [_unchanged, _altered, _half_batches,
                                   _undeformed, _float32])
def test_broken_timed_path_is_not_correct(fault, tmp_path, monkeypatch):
    bench_dir = copy_benchmark(tmp_path, NX)
    sound, _ = run_on_cpu(bench_dir, CELL, seconds=0.3)
    assert sound["correct"], sound["compared"]
    fault(monkeypatch)
    try:
        res, _ = run_on_cpu(bench_dir, CELL, seconds=0.3)
    except RuntimeError:  # set-up or warm-up raised: no result at all
        return
    assert res["correct"] is False, res["compared"]


def test_a_traced_run_reports_the_new_metrics(tmp_path, monkeypatch):
    """A traced run at nx=6 on the CPU, through the card's ``Inverse()``
    branch: the new spans and counter, and the forms cells' program
    metrics, each read; every node of the deformation space shifts, and
    nothing in them reads a device value (no sync on the CPU)."""
    from ngsxfem_tpu_torch.solvers import sparse
    from ngsxfem_tpu_torch.utils import timing

    monkeypatch.setattr(sparse, "_on_card", lambda mat: True)
    timing.reset_trace()
    bench_dir = copy_benchmark(tmp_path, NX)
    res, _ = run_on_cpu(bench_dir, CELL, trace=True)
    timing.reset_trace()
    assert res["correct"], res["compared"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    bench = registry.load_benchmark()
    want = {e["name"] for e in registry.metrics_of(bench, CELL, "per_layer")
            if e["source"] != "device_trace"}
    assert set(NEW_METRICS) <= want <= set(m), (want, set(m))
    # the spans read the profiled step, the blocks the window's mean
    assert m["deform_ms"] > 0 and m["patch_map_ms"] > 0
    assert m["shift_nodes_per_step"] == (2 * NX + 1) ** 3
    assert m["host_syncs_per_step"] == 0
