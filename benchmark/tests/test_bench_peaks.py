"""The yardstick's arithmetic, copied from chip_smoke.py."""
import numpy as np
import pytest

from harness import peaks


def test_flagship_ell_bound():
    """PERF.md's flagship f32 ELL bound: 1,781,257 real slots of the
    117,649-row table, 15.2 MB, 4.535 us."""
    ms, kind = peaks.nnz_bound(1_781_257, 117_649, 117_649, 4)
    assert kind == "bytes"
    assert ms * 1e3 == pytest.approx(4.535, abs=5e-4)


def test_dia_cg_bound_is_operations_bound():
    """PERF.md's B1 bound on the flagship: 5.716 us, operations."""
    n1 = 49
    offs = np.array(sorted({a * n1 * n1 + b * n1 + c for a in (-1, 0, 1)
                            for b in (-1, 0, 1) for c in (-1, 0, 1)}))
    ms, kind = peaks.dia_cg_bound(offs, 117_649, 50)
    assert kind == "operations"
    assert ms * 1e3 == pytest.approx(5.716, abs=5e-3)


def test_solve_least_s_counts_each_part():
    """One product of a table with 10 real slots (f64 value + int32
    column), x read and y written, plus one CG iteration of 7 vectors."""
    n = 4
    t, kind = peaks.solve_least_s([(1, 10, n, 8, 4)], [(1, n, 8)])
    assert kind == "bytes"
    assert t == pytest.approx((10 * 12 + 2 * n * 8 + 7 * n * 8)
                              / peaks.HBM_BYTES_PER_S)
    t0, _ = peaks.solve_least_s([], [])
    assert t0 == 0.0
