"""The benchmark's own tests: the plain reference against the port, the
harness, the yardstick's arithmetic and the comparison's control, on the
CPU at small sizes.  Run from the repository's root:
``python -m pytest benchmark/tests -q``."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def copy_benchmark(dst, nx):
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` under ``dst`` with
    every configuration at ``nx`` cells per axis; returns its
    ``benchmark`` directory."""
    import json
    import shutil

    bench = os.path.join(str(dst), "benchmark")
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), str(dst))
    cdir = os.path.join(bench, "configs")
    for name in os.listdir(cdir):
        if name.endswith(".json"):
            p = os.path.join(cdir, name)
            with open(p) as f:
                d = json.load(f)
            d["nx"] = nx
            with open(p, "w") as f:
                json.dump(d, f)
    return bench


def run_on_cpu(bench_dir, cell, seed=2 ** 31 + 5, seconds=0.5, trace=False):
    """One run of the cell on the CPU: (result, detail)."""
    import time
    import warnings

    import torch
    from harness import runner

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return runner.run_cell(cell, seed, seconds, trace,
                               torch.device("cpu"), time.time(),
                               bench_dir=bench_dir)
