"""Run one cell of the benchmark of ``ngsxfem_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result, one JSON object;
the numbers compared and their limits are the last lines of standard
error.  Detail (every step's time, the samples' readings, the profiled
sub-window) goes to ``build/bench/`` in the checkout.

The run exits with another code than 0, and prints no result, where no
CUDA card is found, where fewer cards are visible than the cell asks for,
or where a module of JAX or of the JAX package ``ngsxfem_tpu`` is loaded
once the window has closed.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ngsxfem_tpu")


def _environment():
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(build, "cuda_cache"))


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)

    import torch
    from harness import registry, runner

    cell = registry.cell(registry.load_benchmark(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, detail = runner.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), device, T0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    out_dir = os.path.join(ROOT, "build", "bench")
    os.makedirs(out_dir, exist_ok=True)
    side = os.path.join(out_dir, f"{args.workload}.{args.seed}."
                        f"{args.trace}.json")
    with open(side, "w") as f:
        json.dump(detail, f, default=str)
    st = detail["step_s"]
    print(f"card {detail['card']}; setup {detail['setup_s']:.3f} s; "
          f"{len(st)} steps in {detail['window_s']:.3f} s; "
          f"compare {detail['compare_s']:.3f} s; detail {side}")
    for e in detail["errors"]:
        print(e, file=sys.stderr)
    for name, (value, limit) in result["compared"].items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
