"""Utilities and the export surface of the PyTorch port, against the JAX
package (CPU, f64).

- ``import ngsxfem_tpu_torch`` offers every public name of ``ngsxfem_tpu``
  but the deliberate absences: ``jitcache`` (the port runs eagerly, no
  program cache), ``parallel`` (ROADMAP A16) and ``jax_trace``, whose place
  ``torch_trace`` takes;
- ``Timer``/``GetTimers``/``PrintTimers``/``region``, ``torch_trace``;
  ``StatisticContainer``/``PrintConvergenceTable`` print what the JAX
  package prints;
- ``IsCut`` and ``kappa`` against the JAX package to 1e-12;
- ``VTKOutput`` (subdivision, steps, ``.pvd``, a matrix field): the numbers
  of the files, parsed, against the JAX package's files to 1e-12;
- ``set_default_dtype`` round trip; ``ngsglobals``/``message``.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu.utils import utils as jutils

CPU = "cpu"
ABSENT = {"jitcache": "the port runs eagerly: no program cache",
          "jax_trace": "torch_trace takes its place"}


def test_export_surface():
    jn = {n for n in dir(J) if not n.startswith("_")}
    tn = {n for n in dir(T) if not n.startswith("_")}
    assert jn - tn <= set(ABSENT), sorted(jn - tn - set(ABSENT))
    assert "torch_trace" in tn and "jax_trace" not in tn
    for name in ("CF", "TO_CDT", "INVERT", "all_domain_types",
                 "all_combined_domain_types", "FESpaceFactory", "dt_vec",
                 "FESpace", "IntegrateX", "SymbolicCutBFI", "SymbolicCutLFI",
                 "TimeVariableCoefficientFunction", "Region", "Periodic",
                 "PeriodicFESpace", "cg_implicit"):
        assert name in T.__all__ and hasattr(T, name), name
    assert T.SymbolicCutBFI is T.SymbolicBFI
    assert isinstance(T.tref, T.TimeVariableCoefficientFunction)
    assert T.TO_CDT(T.NEG) == T.CDOM_NEG and T.INVERT(T.CDOM_NEG) == \
        T.CDOM_POS
    assert list(T.all_domain_types) == [T.NEG, T.POS, T.IF]
    mesh = T.MakeStructured2DMesh(quads=False, nx=4, ny=4)
    lset = T.GridFunction(T.H1(mesh, order=1, device=CPU))
    T.InterpolateToP1(T.x - 0.5, lset)
    assert abs(T.IntegrateX(lset, mesh, 1.0, order=2,
                            domain_type=T.NEG) - 0.5) < 1e-14


def test_timers(capsys):
    from ngsxfem_tpu_torch.utils import timing

    timing.ResetTimers()
    t = T.Timer("a")
    t.Start()
    t.Stop(torch.ones(3))
    with T.Timer("a"):
        pass
    with timing.region("b"):
        pass
    got = timing.GetTimers()
    assert got["a"][1] == 2 and got["b"][1] == 1 and got["a"][0] >= 0.0
    T.PrintTimers()
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["timer", "calls", "total[s]", "per-call[ms]"]
    assert {ln.split()[0] for ln in out[1:]} == {"a", "b"}
    timing.ResetTimers()
    T.PrintTimers()
    assert capsys.readouterr().out == "no timers recorded\n"


def test_torch_trace(tmp_path):
    with T.torch_trace(str(tmp_path)) as prof:
        torch.ones(100).cumsum(0)
    assert prof.key_averages() is not None
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_statistics_print_as_jax(capsys):
    errs = [0.1, 0.026, 0.0061, 0.0]
    outs = []
    for M in (jutils, T):
        sc = M.StatisticContainer()
        for e in errs:
            sc.Add("L2", e)
            sc.Add("max", 2 * e)
        assert sc["L2"] == errs
        sc.Print(label="geom")
        eoc = M.PrintConvergenceTable(errs[:3], label="err")
        outs.append((capsys.readouterr().out, eoc))
    assert outs[0] == outs[1]
    assert abs(outs[1][1] - np.log2(0.026 / 0.0061)) < 1e-14


def test_iscut_and_kappa_match_jax():
    vals = []
    for M, dev in ((J, {}), (T, {"device": CPU})):
        mesh = M.MakeStructured2DMesh(quads=False, nx=8, ny=8)
        lset = M.GridFunction(M.H1(mesh, order=1, **dev))
        M.InterpolateToP1(M.sqrt((M.x - 0.5) ** 2 + (M.y - 0.5) ** 2) - 0.3,
                          lset)
        ic = M.IsCut(mesh, lset)
        k_neg, k_pos = M.kappa(mesh, lset)
        ints = [float(M.Integrate(cf=cf, mesh=mesh, order=2, **dev))
                for cf in (ic, k_neg, k_pos, k_neg * M.x)]
        vals.append((np.asarray(ic.vec.data), ints))
    (icj, ij), (ict, it) = vals
    assert np.array_equal(icj, ict) and 0 < ict.sum() < len(ict)
    assert np.abs(np.asarray(it) - np.asarray(ij)).max() <= 1e-12


def _numbers(path):
    with open(path) as f:
        return np.array([float(t) for t in re.findall(
            r"-?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?", f.read())])


def test_vtk_output_matches_jax(tmp_path):
    files = []
    for M, dev in ((J, {}), (T, {"device": CPU})):
        mesh = M.MakeStructured2DMesh(quads=False, nx=2, ny=2)
        gf = M.GridFunction(M.VectorH1(mesh, order=1, **dev))
        gf.Set(M.CoefficientFunction((M.x * M.y, M.x - M.y)))
        base = str(tmp_path / ("jax" if M is J else "torch") / "out")
        os.makedirs(os.path.dirname(base))
        vtk = M.VTKOutput(mesh, coefs=[M.x, gf, M.grad(gf)],
                          names=["s", "v", "J"], filename=base, subdivision=2)
        f0 = vtk.Do(time=0.0)
        f1 = vtk.Do(time=0.5)
        assert f0.endswith("out.vtk") and "step0001" in f1
        txt0 = open(f0).read()
        assert f"CELL_TYPES {mesh.ne * 16}" in txt0
        assert "FIELD J_field" in txt0
        pvd = open(base + ".pvd").read()
        assert 'timestep="0.5"' in pvd and "step0001" in pvd
        files.append((f0, f1))
        vtk0 = M.VTKOutput(mesh, coefs=[gf], names=["v"],
                           filename=base + "_plain")
        files[-1] += (vtk0.Do(),)
    for fj, ft in zip(*files):
        nj, nt = _numbers(fj), _numbers(ft)
        assert nj.shape == nt.shape
        assert np.abs(nj - nt).max() <= 1e-12, (fj, ft)
    with pytest.raises(ValueError):
        T.VTKOutput(T.MakeStructured2DMesh(nx=1, ny=1), coefs=[T.x],
                    names=[], device=CPU)
    assert T.Draw(None) is None


def test_set_default_dtype_round_trip():
    from ngsxfem_tpu_torch.config import config

    before = config.dtype
    try:
        T.set_default_dtype(torch.float32)
        mesh = T.MakeStructured2DMesh(quads=False, nx=2, ny=2)
        assert T.GridFunction(T.H1(mesh, device=CPU)).vec.data.dtype == \
            torch.float32
        T.set_default_dtype(torch.float64)
        assert T.GridFunction(T.H1(mesh, device=CPU)).vec.data.dtype == \
            torch.float64
        # a dtype numpy names is taken as the JAX package takes it
        T.set_default_dtype(np.float32)
        assert config.dtype is torch.float32
        with pytest.raises(TypeError):
            T.set_default_dtype(np.int32)
    finally:
        config.dtype = before


def test_ngsglobals_message(capsys):
    from ngsxfem_tpu_torch.utils.globals import message

    level = T.ngsglobals.msg_level
    try:
        T.ngsglobals.msg_level = 0
        message(1, "hidden")
        T.ngsglobals.msg_level = 2
        message(2, "shown", 3)
    finally:
        T.ngsglobals.msg_level = level
    assert capsys.readouterr().out == "shown 3\n"
    assert repr(T.ngsglobals).startswith("ngsglobals(")
