"""The comparison fails what it has to fail, on the CPU at small sizes.

The control (each configuration's reference one precision below, in the
program's place) fails the cell's limits, and a run whose timed path is
broken underneath reports ``correct`` false: a step that leaves its state
unchanged, an answer altered where it is produced, and half of the
assembled contributions left out (the cells have no batch and no exchange
between chips); and, in the lattice cell, the solve's float64 products
computed in float32 instead."""
import warnings

import pytest
import torch

from conftest import copy_benchmark, run_on_cpu
from harness import judge, registry
from harness.traffic import Generator

CELLS = ["fictdom3d-p1-forms.moving", "fictdom3d-p1-lattice.moving",
         "fictdom3d-p1-forms.loads"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell, tmp_path):
    bench_dir = copy_benchmark(tmp_path, 6)
    bench = registry.load_benchmark(str(tmp_path))
    c = registry.cell(bench, cell)
    sizes = registry.sizes(bench, c["config"], bench_dir)
    traffic = registry.traffic(cell, bench_dir)
    gen = Generator(traffic, sizes, 11)
    inputs = [next(gen) for _ in range(3)][1:]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = registry.driver(c["config"], bench_dir).control(
            sizes, traffic, inputs, torch.device("cpu"), 11)
    ok, table = judge.verdict(judge.worst(r), traffic["limits"])
    assert not ok, table


def _once(fn):
    """``fn`` on its first call; afterwards its first result again."""
    memo = []

    def wrapped(*a, **k):
        if not memo:
            memo.append(fn(*a, **k))
        return memo[0]
    return wrapped


def _unchanged(cell, mp):
    if cell == "fictdom3d-p1-forms.moving":
        from ngsxfem_tpu_torch.geom.cutinfo import CutInfo
        first = []

        def update(self, *a, **k):
            if not first:
                first.append(1)
                return orig(self, *a, **k)
        orig = CutInfo.Update
        mp.setattr(CutInfo, "Update", update)
    elif cell == "fictdom3d-p1-lattice.moving":
        from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
        mp.setattr(UnfittedPoisson, "assemble_vals_lattice",
                   _once(UnfittedPoisson.assemble_vals_lattice))
    else:
        from ngsxfem_tpu_torch.forms.assemble import LinearForm
        orig = LinearForm.Assemble
        done = []

        def assemble(self, *a, **k):
            if not done:
                done.append(1)
                return orig(self, *a, **k)
            return self
        mp.setattr(LinearForm, "Assemble", assemble)


def _altered(cell, mp):
    def alter(x):
        x = x.clone()
        i = int(x.abs().argmax())
        x[i] = x[i] * 1.1
        return x

    if cell.startswith("fictdom3d-p1-forms"):
        from ngsxfem_tpu_torch.solvers.sparse import InverseMatrix
        orig = InverseMatrix.solve
        mp.setattr(InverseMatrix, "solve",
                   lambda self, rhs: alter(orig(self, rhs)))
    else:
        from ngsxfem_tpu_torch.solvers import krylov
        orig = krylov.cg_ir

        def cg_ir(*a, **k):
            x, res = orig(*a, **k)
            return alter(x), res
        mp.setattr(krylov, "cg_ir", cg_ir)


def _half(cell, mp):
    if cell.startswith("fictdom3d-p1-forms"):
        from ngsxfem_tpu_torch.forms.assemble import BilinearForm
        orig = BilinearForm.Assemble

        def assemble(self, *a, **k):
            orig(self, *a, **k)
            self.mat.vals = self.mat.vals.clone()
            self.mat.vals[1::2] = 0.0
            return self
        mp.setattr(BilinearForm, "Assemble", assemble)
    else:
        from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
        orig = UnfittedPoisson.assemble_vals_lattice

        def asm(self, *a, **k):
            V, ncut = orig(self, *a, **k)
            V = V.clone()
            V[:, 1::2] = 0.0
            return V, ncut
        mp.setattr(UnfittedPoisson, "assemble_vals_lattice", asm)


@pytest.mark.parametrize("fault", [_unchanged, _altered, _half])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, tmp_path,
                                          monkeypatch):
    bench_dir = copy_benchmark(tmp_path, 6)
    sound, _ = run_on_cpu(bench_dir, cell, seconds=0.3)
    assert sound["correct"], sound["compared"]
    fault(cell, monkeypatch)
    try:
        res, _ = run_on_cpu(bench_dir, cell, seconds=0.3)
    except RuntimeError:  # set-up or warm-up raised: no result at all
        return
    assert res["correct"] is False, res["compared"]


def test_solve_without_float64_residuals_is_not_correct(tmp_path,
                                                        monkeypatch):
    """The lattice cell's ``res`` catches a solve whose float64 products
    (the refinement's outer residuals and the fallback's) are float32
    products, though the solution stays close to the reference's."""
    cell = "fictdom3d-p1-lattice.moving"
    bench_dir = copy_benchmark(tmp_path, 6)
    from ngsxfem_tpu_torch.solvers import sparse
    orig = sparse.dia_matvec

    def dia_matvec(offsets, V, x):
        if x.dtype == torch.float64:
            return orig(offsets, V.float(), x.float()).double()
        return orig(offsets, V, x)
    monkeypatch.setattr(sparse, "dia_matvec", dia_matvec)
    res, _ = run_on_cpu(bench_dir, cell, seconds=0.3)
    assert res["correct"] is False, res["compared"]
    value, limit = res["compared"]["res"]
    assert value > limit, res["compared"]
    for name in ("op", "sol"):
        assert res["compared"][name][0] <= res["compared"][name][1]
