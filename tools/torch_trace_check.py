"""Check the port's sync counter against the profiler's own record, on a
CUDA card.

    python3 tools/torch_trace_check.py [cell ...]

from the repository's root.  For each benchmark cell (all three by
default) it sets the cell up as ``benchmark/run.py`` does, runs one warm-up
step, then one step under ``utils.timing.torch_trace`` and compares two
counts of the host's synchronising CUDA calls inside the program's spans:

- ``store``: the ``host_syncs`` counter of the spans the step recorded
  (``utils.timing.spans``);
- ``trace``: the runtime calls ``cudaStreamSynchronize``,
  ``cudaDeviceSynchronize`` and ``cudaMemcpy`` in the Chrome trace that lie
  inside a host annotation of a program span (a ``cudaMemcpyAsync``
  followed by a synchronise counts once, by its synchronise).

Then it measures what the spans cost: ``ROUNDS`` rounds of three steps,
one with no profiler, one under ``torch.profiler`` (host and card, as the
benchmark's traced runs take it) with the program's tracing on, and one
under the same profiler with the program's tracing held off; per kind the
mean host time of a step (synchronised) and of the spans
``SparseMatrix::to_ell`` and ``cg`` (their ``GetTimers`` totals, kept in
every kind).

It prints one JSON line per cell, with the counts per span, the CG
iterations and the times, and exits 1 where the two counts differ.
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
CELLS = ["fictdom3d-p1-forms.moving", "fictdom3d-p1-lattice.moving",
         "fictdom3d-p1-forms.loads"]
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")
ROUNDS = 4
TIMED_SPANS = ("SparseMatrix::to_ell", "cg")


def trace_syncs(path, names):
    """{span: synchronising runtime calls inside its host annotations} of
    a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in names)
    out = {}
    for e in events:
        if e.get("cat") != "cuda_runtime" or e.get("name") not in SYNC_CALLS:
            continue
        for s, t, n in spans:
            if s <= e["ts"] <= t:
                out[n] = out.get(n, 0) + 1
                break
    return out


def check_cell(cell, device):
    import torch
    from harness import registry
    from harness.trace import Spans
    from harness.traffic import Generator
    from ngsxfem_tpu_torch.utils import timing

    bench = registry.load_benchmark(ROOT)
    c = registry.cell(bench, cell)
    sizes = registry.sizes(bench, c["config"])
    traffic = registry.traffic(cell)
    drv = registry.driver(c["config"])
    gen = Generator(traffic, sizes, 2 ** 31 + 11)
    state = drv.setup(sizes, traffic, device)
    drv.step(state, next(gen), Spans(None))  # warm-up
    torch.cuda.synchronize(device)
    timing.reset_trace()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        t0 = time.perf_counter()
        with timing.torch_trace(d):
            drv.step(state, next(gen), Spans(None))
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        recs = timing.spans()
        names = {r["name"] for r in recs}
        traced = trace_syncs(os.path.join(d, "trace.json"), names)
    store = {}
    for r in recs:
        n = r["counters"].get(timing.SYNC_COUNTER, 0)
        if n:
            store[r["name"]] = store.get(r["name"], 0) + n
    cost = on_cost(lambda: drv.step(state, next(gen), Spans(None)), device)
    drv.release(state)
    del state
    torch.cuda.empty_cache()
    return {"cell": cell, "nx": sizes["nx"], "store": sum(store.values()),
            "trace": sum(traced.values()), "store_by_span": store, "trace_by_span": traced,
            "cg_iterations": sum(r["counters"].get("cg::iterations", 0)
                                 for r in recs),
            "spans": len(recs), "wall_s": wall, "cost_ms": cost,
            "equal": store == traced}


def on_cost(step, device):
    """{kind: {"step": ms, span: ms}}: mean host times per step of the
    three kinds, taken in turns (module docstring)."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile
    from ngsxfem_tpu_torch.utils import timing

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    on = timing._tracing
    kinds = {"off": contextlib.nullcontext,
             "profiled": lambda: profile(activities=acts),
             "profiled_quiet": lambda: profile(activities=acts)}
    sums = {k: {} for k in kinds}
    for _ in range(ROUNDS):
        for kind, ctx in kinds.items():
            before = timing.GetTimers()
            with ctx():
                if kind == "profiled_quiet":
                    timing._tracing = lambda: False
                try:
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize(device)
                    dt = time.perf_counter() - t0
                finally:
                    timing._tracing = on
            after = timing.GetTimers()
            got = sums[kind]
            got["step"] = got.get("step", 0.0) + dt
            for name in TIMED_SPANS:
                d = after.get(name, (0.0, 0))[0] - before.get(name,
                                                            (0.0, 0))[0]
                got[name] = got.get(name, 0.0) + d
    timing.reset_trace()
    return {k: {n: 1e3 * v / ROUNDS for n, v in d.items()}
            for k, d in sums.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="*", default=CELLS)
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH, ROOT]
    import run  # the benchmark's build and cache paths

    run._environment()
    import torch

    if not torch.cuda.is_available():
        print("torch_trace_check: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ok = True
    for cell in args.cells:
        out = check_cell(cell, device)
        ok &= out["equal"]
        print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
