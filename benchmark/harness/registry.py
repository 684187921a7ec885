"""Find a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names every configuration,
cell and metric; each has a file of its own under ``benchmark/``:

- ``configs/<config>.json``: the sizes, as the entry's ``file`` says, and
  ``configs/<config>.py`` beside it: the driver of the program and the
  glue to the plain reference for that configuration;
- ``workloads/<cell>.json``: the cell's traffic parameters and the limits
  of its comparison;
- ``metrics/<metric>.py``: a reader with ``read(ctx)``.

A later cell, configuration or metric is added with its files and its
entry, and no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench, name):
    return _by_name(bench["workloads"], name, "workload")


def sizes(bench, name, bench_dir=BENCH_DIR):
    """The sizes of a configuration: the JSON file its entry names."""
    entry = _by_name(bench["configs"], name, "configuration")
    with open(os.path.join(os.path.dirname(bench_dir), entry["file"])) as f:
        return json.load(f)


def traffic(name, bench_dir=BENCH_DIR):
    with open(os.path.join(bench_dir, "workloads", f"{name}.json")) as f:
        return json.load(f)


def _module(path, modname):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(config_name, bench_dir=BENCH_DIR):
    """The configuration's driver module, ``configs/<config>.py``."""
    return _module(os.path.join(bench_dir, "configs", f"{config_name}.py"),
                   "bench_config_" + config_name.replace("-", "_")
                   .replace(".", "_"))


def metric(name, bench_dir=BENCH_DIR):
    """The reader module of a metric, ``metrics/<metric>.py``."""
    return _module(os.path.join(bench_dir, "metrics", f"{name}.py"),
                   "bench_metric_" + name.replace("-", "_").replace(".", "_"))


def metrics_of(bench, cell_name, kind):
    """The ``end_to_end`` or ``per_layer`` entries that the cell reports:
    those without a ``workloads`` key and those that list the cell."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]
