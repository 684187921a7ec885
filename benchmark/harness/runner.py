"""One run of one cell: set-up, warm-up, the measured window, the profiled
sub-window of a traced run, the comparison, and the result's line.

The window is a closed loop with one caller: each step starts when the
previous one has ended, its solution on the device and synchronised.  It
runs whole steps until ``seconds`` have passed; a rate taken over it holds
all of its work and all of its time.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
import traceback
from types import SimpleNamespace

import torch

from . import judge, registry
from .trace import Spans, profile
from .traffic import Generator, Reservoir

BREAKDOWN_ENTRIES = 6
NAME_CHARS = 48
LINE_CHARS = 1900
# profiled sub-windows a traced run takes at most: now and then the
# profiler records no device event in a window, which is then taken again
PROFILE_TRIES = 3


def _card(device):
    """The card's name and what ``nvidia-smi`` says of its power and
    clocks (a dict; empty where it cannot be asked)."""
    out = {"name": torch.cuda.get_device_name(device)}
    try:
        q = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=power.limit,power.draw,clocks.sm,clocks.max.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        out["nvidia_smi"] = q.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def run_cell(cell_name, seed, seconds, trace, device, t0,
             bench_dir=registry.BENCH_DIR):
    """Run the cell once; returns (the result's dict, the detail dict)."""
    root = os.path.dirname(bench_dir)
    bench = registry.load_benchmark(root)
    cell = registry.cell(bench, cell_name)
    sizes = registry.sizes(bench, cell["config"], bench_dir)
    traffic = registry.traffic(cell_name, bench_dir)
    drv = registry.driver(cell["config"], bench_dir)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    spans = Spans(sync if trace else None)
    gen = Generator(traffic, sizes, seed)

    state = drv.setup(sizes, traffic, device)
    drv.step(state, next(gen), Spans(None))  # warm-up: every shape of the cell
    sync()
    setup_s = time.time() - t0

    times, errors = [], []
    attempted = failed = 0
    sample = Reservoir(traffic["sample"], seed)
    w0 = time.perf_counter()
    while True:
        inp = next(gen)
        s0 = time.perf_counter()
        try:
            out = drv.step(state, inp, spans)
            sync()
        except Exception:  # a step that raises counts as failed
            failed += 1
            if len(errors) < 3:
                errors.append(traceback.format_exc(limit=4))
            out = None
        s1 = time.perf_counter()
        attempted += 1
        if out is not None:
            times.append(s1 - s0)
            sample.offer((inp, out))
        if s1 - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0

    # the spans of the window, without the profiled steps' own cost
    span_s = {k: list(v) for k, v in spans.durations.items()}
    summary, work = None, []
    for _ in range(PROFILE_TRIES if trace else 0):
        outs = []

        def steps():
            for _ in range(traffic["trace_steps"]):
                outs.append(drv.step(state, next(gen), spans))
                sync()

        summary = profile(steps, spans, cuda)
        work = [drv.work(state, o) for o in outs]
        del outs
        if not cuda or (summary and summary["n_ops"]):
            break

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    card = _card(device) if cuda else {"name": "cpu"}
    meta = drv.release(state)
    del state

    c0 = time.perf_counter()
    readings = drv.compare(sizes, traffic, sample.items, meta, device, seed)
    values = judge.worst(readings) if readings else {}
    ok, table = judge.verdict(values, traffic["limits"])
    correct = bool(ok and readings and failed == 0 and times)
    compare_s = time.perf_counter() - c0

    ctx = SimpleNamespace(cell=cell_name, step_s=times, window_s=window_s,
                          setup_s=setup_s, spans=span_s,
                          trace=summary, work=work,
                          trace_steps=traffic["trace_steps"])
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.metrics_of(bench, cell_name, kind):
        v = registry.metric(m["name"], bench_dir).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": card["name"], "count": cell["chips"],
                         "memory_peak_bytes": int(peak)}}
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = breakdown(summary)
    result["compared"] = table
    detail = {"cell": cell_name, "seed": seed, "trace": trace, "card": card,
              "setup_s": setup_s, "window_s": window_s, "step_s": times,
              "errors": errors, "compare_s": compare_s,
              "readings": readings, "spans": span_s,
              "trace_summary": summary, "work": work,
              "sampled_steps": [inp.index for inp, _ in sample.items]}
    return fit(result), detail


def short_name(name):
    """A device operation's name without ``void``, PyTorch's namespaces and
    its arguments, cut to ``NAME_CHARS``."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::", "at::",
                 "std::"):
        name = name.replace(junk, "")
    return name.split("(")[0][:NAME_CHARS]


def breakdown(summary):
    """The device operations that took most time (summed by short name) and
    the idle time by the span that was open, each list longest first."""
    def top(d):
        items = sorted(d.items(), key=lambda kv: -kv[1])
        return [[k, v] for k, v in items[:BREAKDOWN_ENTRIES]]

    ops = {}
    for k, v in summary["ops"].items():
        ops[short_name(k)] = ops.get(short_name(k), 0.0) + v
    return {"device_ops": top(ops), "idle_gaps": top(summary["idle"])}


def fit(result):
    """Shorten the breakdown until the line fits in ``LINE_CHARS``."""
    while len(json.dumps(result)) > LINE_CHARS and result.get("breakdown"):
        b = result["breakdown"]
        key = max(b, key=lambda k: len(json.dumps(b[k])))
        if not b[key]:
            break
        b[key].pop()
    return result
