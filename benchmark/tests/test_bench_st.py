"""The space-time configuration ``movingdomain3d-st-p1`` on the CPU at
nx = 6: the control fails the limits, the faults the comparison has to
catch give ``correct`` false, and a traced run reports the new per-layer
metrics, which read nothing where the program keeps no such record.  (That
its plain reference ``reference/stcut.py`` imports nothing of the program
is ``test_bench_reference.py``'s check of every reference.)"""
import warnings
from types import SimpleNamespace

import pytest
import torch

from conftest import copy_benchmark, run_on_cpu
from harness import judge, registry
from harness.traffic import Generator

CPU = torch.device("cpu")
CONFIG = "movingdomain3d-st-p1"
CELL = "movingdomain3d-st-p1.slabs"
NX = 6
NEW_METRICS = ("st_rule_ms", "host_lu_ms", "st_cut_elements_per_step")


def test_control_fails_the_limits():
    sizes = {**registry.sizes(registry.load_benchmark(), CONFIG), "nx": NX}
    traffic = registry.traffic(CELL)
    gen = Generator(traffic, sizes, 2 ** 31 + 19)
    inputs = [next(gen) for _ in range(4)][2:]
    r = registry.driver(CONFIG).control(sizes, traffic, inputs, CPU,
                                        2 ** 31 + 19)
    ok, table = judge.verdict(judge.worst(r), traffic["limits"])
    assert not ok, table
    assert all(table[k][0] > table[k][1] for k in ("op", "load", "sol")), \
        table


def _unchanged(mp):
    """The slab's level set interpolated for the first slab only."""
    import ngsxfem_tpu_torch as api

    orig = api.SpaceTimeInterpolateToP1
    done = []

    def interpolate(*a, **k):
        if not done:
            done.append(1)
            orig(*a, **k)
    mp.setattr(api, "SpaceTimeInterpolateToP1", interpolate)


def _not_carried(mp):
    """The solution's top never restricted into ``uold``: every slab starts
    from the initial values."""
    import ngsxfem_tpu_torch as api

    orig = api.RestrictGFInTime

    def restrict(spacetime_gf=None, reference_time=0.0, space_gf=None):
        if reference_time != 1.0:
            orig(spacetime_gf=spacetime_gf, reference_time=reference_time,
                 space_gf=space_gf)
    mp.setattr(api, "RestrictGFInTime", restrict)


def _load_altered(mp):
    from ngsxfem_tpu_torch.forms.assemble import LinearForm

    orig = LinearForm.Assemble

    def assemble(self, *a, **k):
        out = orig(self, *a, **k)
        self._vec = self._vec * 1.1
        return out
    mp.setattr(LinearForm, "Assemble", assemble)


def _no_ghost_penalty(mp):
    """No facet selected for the ghost penalty."""
    import numpy as np

    import ngsxfem_tpu_torch as api

    mp.setattr(api, "GetFacetsWithNeighborTypes", lambda mesh, **k:
               api.BitArray(np.zeros(mesh.nfacets, dtype=bool)))


def _float32(mp):
    """The program's tables, load and solution in float32."""
    from ngsxfem_tpu_torch.config import config

    mp.setattr(config, "dtype", torch.float32)


@pytest.mark.parametrize("fault", [_unchanged, _not_carried, _load_altered,
                                   _no_ghost_penalty, _float32])
def test_broken_slab_is_not_correct(fault, tmp_path, monkeypatch):
    bench_dir = copy_benchmark(tmp_path, NX)
    sound, _ = run_on_cpu(bench_dir, CELL, seconds=0.6)
    assert sound["correct"], sound["compared"]
    fault(monkeypatch)
    try:
        res, _ = run_on_cpu(bench_dir, CELL, seconds=0.6)
    except RuntimeError:  # set-up or warm-up raised: no result at all
        return
    assert res["correct"] is False, res["compared"]


def test_a_traced_run_reports_the_new_metrics(tmp_path, monkeypatch):
    """A traced run at nx=6 on the CPU, through the card's ``Inverse()``
    branch (``to_ell`` and the failing SPD check, then the host LU): every
    per-layer metric of the cell that the program's record gives, the new
    ones among them, and no sync on the CPU."""
    from ngsxfem_tpu_torch.solvers import sparse
    from ngsxfem_tpu_torch.utils import timing

    monkeypatch.setattr(sparse, "_on_card", lambda mat: True)
    timing.reset_trace()
    bench_dir = copy_benchmark(tmp_path, NX)
    res, _ = run_on_cpu(bench_dir, CELL, trace=True)
    recs = timing.spans()
    timing.reset_trace()
    assert res["correct"], res["compared"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    bench = registry.load_benchmark()
    want = {e["name"] for e in registry.metrics_of(bench, CELL, "per_layer")
            if e["source"] != "device_trace"}
    assert set(NEW_METRICS) <= want <= set(m), (want, set(m))
    assert m["st_rule_ms"] > 0 and m["host_lu_ms"] > 0
    # three rules a slab, each over the slab's cut elements
    assert m["st_cut_elements_per_step"] > 0
    assert m["st_cut_elements_per_step"] % 3 == 0
    assert m["host_syncs_per_step"] == 0
    # the host LU ran once a step, inside the solve
    names = [r["name"] for r in recs]
    assert names.count("InverseMatrix::host_lu") == names.count(
        "InverseMatrix::Solve")


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_metrics_read_none_without_a_record(name, monkeypatch):
    """As on a program without the spans: None, not 0."""
    from ngsxfem_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "spans", lambda: [
        {"name": "InverseMatrix::Solve", "start_ns": 0, "end_ns": 5,
         "parent": -1, "counters": {}}])
    ctx = SimpleNamespace(spans={}, trace=None, trace_steps=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert registry.metric(name).read(ctx) is None
