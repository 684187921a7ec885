"""Run chip_smoke.py's differentiable-FEM and periodic phases (26-27) alone
on one CUDA card.

    python3 tools/torch_ad_phases.py     (from the repository root)

Builds the ELL kernel B2 and the row-major kernel it replaced (B2's timings
set them side by side) as chip_smoke.py does, builds the f64 flagship model
at nx=48 and its structures (chip_smoke.py reuses phase 13's), then runs
phases 26 and 27 (every check of the whole script included) and prints
their lines, B2's launches per phase and the wall time.
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
        print("torch_ad_phases: no CUDA device", file=sys.stderr)
        return 1
    import ngsxfem_tpu_torch as T
    from ngsxfem_tpu_torch.kernels import build

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the allocator's statistics exist from here
    print(cs.card(), torch.__version__, torch.version.cuda, flush=True)
    build.build_all(["ell_spmv", "ell_spmv_rowmajor"],
                    {"ell_spmv_rowmajor": os.path.join(
                        cs.TOOLS, "torch_ell_spmv_rowmajor.cu")})
    print(f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    ad, per, tables = cs.phases_26_27(T, dev, t0)
    print(json.dumps({"launches_autograd": ad, "launches_periodic": per,
                      "autograd_tables": tables}))
    print(f"total {time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
