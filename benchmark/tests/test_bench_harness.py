"""The harness on the CPU: BENCHMARK.json against the rules of its format,
the result's line, finding pieces by name, and the modules a run loads."""
import hashlib
import json
import os
import re
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, copy_benchmark, run_on_cpu
from harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"correct", "attempted", "failed", "metrics", "device"}
CELLS = ["fictdom3d-p1-forms.moving", "fictdom3d-p1-lattice.moving",
         "fictdom3d-p1-forms.loads"]


@pytest.fixture(scope="module")
def bench():
    return registry.load_benchmark()


def test_names_units_and_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert all(PATH.match(p) for p in bench["paths"])
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        assert c["file"].startswith(bench["paths"][0] + "/")
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            extra = {"layer", "moves"} if kind == "per_layer" else {"bound"}
            assert set(m) - {"workloads"} == {"name", "unit", "better",
                                              "source"} | extra
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))
    assert {m["name"] for m in bench["end_to_end"]} >= {"setup_s"}
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in bench["end_to_end"])
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_piece_has_its_file(bench):
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert os.path.exists(os.path.join(BENCH, "configs",
                                           c["name"] + ".py"))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "workloads",
                                           w["name"] + ".json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(registry.metric(m["name"]), "read")


def test_moves_names_a_metric_each_cell_reports(bench):
    for m in bench["per_layer"]:
        e2e = [e for e in bench["end_to_end"] if e["name"] == m["moves"]]
        assert len(e2e) == 1
        for cell in m.get("workloads", [w["name"] for w in
                                        bench["workloads"]]):
            assert "workloads" not in e2e[0] or cell in e2e[0]["workloads"]
    for w in bench["workloads"]:
        reported = registry.metrics_of(bench, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert registry.metrics_of(bench, w["name"], "per_layer")


@pytest.mark.parametrize("cell", ["fictdom3d-p1-forms.moving",
                                  "fictdom3d-p1-lattice.moving"])
def test_walk_spans_its_box_and_never_repeats(bench, cell):
    """Every seed walks the same positions, in chords of h/4; a window's
    worth of steps reaches the box's faces in each coordinate, stays in
    the box and comes back to no position."""
    import numpy as np
    from harness.traffic import Generator

    c = registry.cell(bench, cell)
    sizes = registry.sizes(bench, c["config"])
    traffic = registry.traffic(cell)
    box, n = traffic["walk"]["box"], 100
    paths = []
    for seed in (1, 2 ** 31 + 7):
        gen = Generator(traffic, sizes, seed)
        paths.append(np.array([next(gen).centre for _ in range(n)]))
    np.testing.assert_array_equal(paths[0], paths[1])
    p = paths[0] - np.asarray(sizes["centre"])
    lo, hi = sizes["box"]
    step = traffic["walk"]["step_h"] * (hi - lo) / sizes["nx"]
    np.testing.assert_allclose(np.linalg.norm(np.diff(p, axis=0), axis=1),
                               step, rtol=1e-9)
    assert np.abs(p).max() <= box * (1 + 1e-12)
    assert (np.abs(p).max(0) >= 0.99 * box).all()
    gaps = np.linalg.norm(p[:, None] - p[None], axis=2) + np.eye(n)
    assert gaps.min() >= 0.99 * step


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_required_keys(tmp_path, trace):
    bench_dir = copy_benchmark(tmp_path, 4)
    res, _ = run_on_cpu(bench_dir, "fictdom3d-p1-forms.moving", trace=trace)
    line = json.dumps(res)
    assert len(line) < 2000
    want = KEYS | {"compared"} | ({"breakdown"} if trace else set())
    assert set(res) == want and list(res)[-1] == "compared"
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"assemble_ms", "solve_ms"} <= set(res["metrics"])
    else:
        assert {"step_ms", "setup_s"} <= set(res["metrics"])


def _digest(d):
    h = {}
    for r, _, files in os.walk(d):
        for f in files:
            p = os.path.join(r, f)
            h[os.path.relpath(p, d)] = hashlib.sha1(
                open(p, "rb").read()).hexdigest()
    return h


def test_new_pieces_are_found_without_editing_a_file(tmp_path):
    """A configuration, a cell and a metric added as files and entries."""
    bench_dir = copy_benchmark(tmp_path, 4)
    before = _digest(bench_dir)
    with open(os.path.join(bench_dir, "configs",
                           "fictdom3d-p1-forms.json")) as f:
        sizes = json.load(f)
    sizes["radius"] = 0.6
    with open(os.path.join(bench_dir, "configs", "toy-forms.json"),
              "w") as f:
        json.dump(sizes, f)
    with open(os.path.join(bench_dir, "configs",
                           "fictdom3d-p1-forms.py")) as f:
        driver = f.read()
    with open(os.path.join(bench_dir, "configs", "toy-forms.py"), "w") as f:
        f.write(driver)
    with open(os.path.join(bench_dir, "workloads",
                           "fictdom3d-p1-forms.loads.json")) as f:
        traffic = f.read()
    with open(os.path.join(bench_dir, "workloads", "toy-forms.loads.json"),
              "w") as f:
        f.write(traffic)
    with open(os.path.join(bench_dir, "metrics", "toy_steps.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx.step_s))\n")
    bj = os.path.join(str(tmp_path), "BENCHMARK.json")
    with open(bj) as f:
        b = json.load(f)
    b["configs"].append({"name": "toy-forms", "source": "https://x.test",
                         "file": "benchmark/configs/toy-forms.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "toy-forms.loads", "config": "toy-forms",
                           "traffic": "loads", "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "toy_steps", "unit": "steps",
                            "better": "higher", "bound": 0.1,
                            "source": "host_clock",
                            "workloads": ["toy-forms.loads"]})
    with open(bj, "w") as f:
        json.dump(b, f)
    res, _ = run_on_cpu(bench_dir, "toy-forms.loads")
    assert res["correct"] is True
    assert res["metrics"]["toy_steps"]["value"] >= 1
    after = _digest(bench_dir)
    assert all(after[k] == v for k, v in before.items())


def _python(code, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_cpu_run_loads_no_jax(tmp_path):
    bench_dir = copy_benchmark(tmp_path, 4)
    code = (f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n"
            "import run\n"
            "from conftest import run_on_cpu\n"
            f"res, _ = run_on_cpu({bench_dir!r}, "
            "'fictdom3d-p1-lattice.moving')\n"
            "assert res['correct'], res\n"
            "import ngsxfem_tpu_torch\n"
            "print(run.forbidden_modules())\n")
    p = _python(code, os.path.join(BENCH, "tests"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    if p.returncode == 0:
        pytest.skip("a CUDA card is visible here")
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


def test_without_the_program_no_result(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ alone: the run fails
    before a result."""
    bench_dir = copy_benchmark(tmp_path, 4)
    code = ("import sys, time, torch\n"
            f"sys.path[:0] = [{bench_dir!r}]\n"
            "from harness import runner\n"
            f"runner.run_cell({CELLS[0]!r}, 1, 0.5, False, "
            f"torch.device('cpu'), time.time(), bench_dir={bench_dir!r})\n")
    p = _python(code, str(tmp_path))
    assert p.returncode != 0 and "ngsxfem_tpu_torch" in p.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_run_on_the_card(tmp_path, cell):
    """Each cell at nx=8 on the card: correct, with every per-layer metric
    a traced run reports there."""
    import time

    import torch
    from harness import runner

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench_dir = copy_benchmark(tmp_path, 8)
    res, _ = runner.run_cell(cell, 2 ** 31 + 9, 1.0, True,
                             torch.device("cuda", 0), time.time(),
                             bench_dir=bench_dir)
    assert res["correct"], res["compared"]
    assert res["device"]["busy_s"] > 0
    bench = registry.load_benchmark(str(tmp_path))
    want = {m["name"] for m in registry.metrics_of(bench, cell, "per_layer")}
    assert want == set(res["metrics"])
