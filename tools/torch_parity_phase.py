"""Run chip_smoke.py's phase 30 (the public-API paths the parity run with
the JAX package's own tests repaired) alone on one CUDA card.

    python3 tools/torch_parity_phase.py     (from the repository root)

Builds the ELL kernel B2 as chip_smoke.py does, builds and assembles the
public-API flagship (``examples.fictdom3d`` P1 f64 at nx=48, the system the
whole script takes from phase 28), then runs phase 30 (every check of the
whole script included) and prints its lines, B2's launches and the wall
time.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_parity_phase: no CUDA device", file=sys.stderr)
        return 1
    from ngsxfem_tpu_torch.examples import fictdom3d
    from ngsxfem_tpu_torch.kernels import build

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    print(cs.card(), torch.__version__, torch.version.cuda, flush=True)
    build.build_all(["ell_spmv"])
    print(f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    a, f, Vh, free, _ = fictdom3d.system(nx=cs.PAR_API_NX, device=dev)
    a.Assemble()
    f.Assemble()
    a.mat.ell()
    cs.sync(dev)
    print(f"fictdom3d nx={cs.PAR_API_NX} system in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out = cs.phase_30(dev, (a, f, Vh, free), t0)
    print(json.dumps({"launches_slice15": out["launches"]}))
    print(f"total {time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
