"""Readings that a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> --seed0 <s>
        [--seconds <s>] [--span <k>] [--control <m>]

One process builds the cell's set-up once, then for each of ``n`` seeds
(``s``, ``s + 1``, ...) runs a short window of the timed step at the
cell's own size and load, samples its steps as a run does and compares
them with the plain reference: the largest of each number over the seeds
is the lower reading.  Every seed walks the same path, so with ``--span
k`` each seed's short window starts at a step drawn from the seed among
the first ``k`` of the cell's traffic (about as many as a run's window
holds), and the seeds together judge positions across a whole window.  With ``--control m`` it then computes, for the
first ``m`` seeds' sampled inputs, the same numbers for the reference
itself in the program's place one precision below (each configuration's
``control``): the smallest of each number over those seeds is the upper
reading.  Prints one JSON line per seed and a summary line; the benchmark's
runs never run this.
"""
import argparse
import json
import os
import random
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))


def readings(cell, seeds, seconds, control, device, bench_dir, span=0):
    """([(seed, worst numbers of the program)], [(seed, control
    numbers)])."""
    from harness import judge, registry
    from harness.trace import Spans
    from harness.traffic import Generator, Reservoir

    bench = registry.load_benchmark(os.path.dirname(bench_dir))
    c = registry.cell(bench, cell)
    sizes = registry.sizes(bench, c["config"], bench_dir)
    traffic = registry.traffic(cell, bench_dir)
    drv = registry.driver(c["config"], bench_dir)
    sync = ((lambda: __import__("torch").cuda.synchronize(device))
            if device.type == "cuda" else (lambda: None))
    st = drv.setup(sizes, traffic, device)
    off = Spans(None)
    prog, inputs = [], {}
    for seed in seeds:
        gen = Generator(traffic, sizes, seed)
        start = random.Random(seed).randrange(span) if span else 0
        for _ in range(start):
            next(gen)
        drv.step(st, next(gen), off)  # the run's warm-up step
        sample = Reservoir(traffic["sample"], seed)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            inp = next(gen)
            out = drv.step(st, inp, off)
            sync()
            sample.offer((inp, out))
        r = drv.compare(sizes, traffic, sample.items, drv.release(st),
                        device, seed)
        prog.append((seed, judge.worst(r), len(r), sample.seen))
        inputs[seed] = [inp for inp, _ in sample.items]
        print(json.dumps({"seed": seed, "program": prog[-1][1],
                          "start": start, "steps": sample.seen}), flush=True)
    del st
    ctrl = []
    for seed in seeds[:control]:
        r = drv.control(sizes, traffic, inputs[seed], device, seed)
        ctrl.append((seed, judge.worst(r)))
        print(json.dumps({"seed": seed, "control": ctrl[-1][1]}), flush=True)
    return prog, ctrl


def summary(prog, ctrl):
    """{number: [lower reading, upper reading]}."""
    out = {}
    for _, w, *_ in prog:
        for k, v in w.items():
            lo_hi = out.setdefault(k, [v, None])
            lo_hi[0] = max(lo_hi[0], v)
    for _, w in ctrl:
        for k, v in w.items():
            lo_hi = out.setdefault(k, [None, v])
            lo_hi[1] = v if lo_hi[1] is None else min(lo_hi[1], v)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--seed0", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--span", type=int, default=0)
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seeds = [args.seed0 + i for i in range(args.seeds)]
    prog, ctrl = readings(args.workload, seeds, args.seconds, args.control,
                          device, HERE, args.span)
    print(json.dumps({"workload": args.workload,
                      "card": torch.cuda.get_device_name(device),
                      "readings": summary(prog, ctrl)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
