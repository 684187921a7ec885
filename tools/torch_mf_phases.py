"""Run chip_smoke.py's matrix-free phases (22-23) alone on one CUDA card.

    python3 tools/torch_mf_phases.py     (from the repository root)

Builds the kernels as chip_smoke.py does, builds phase 19's two high_order
systems (P2 nx=48, P3 nx=24, without phase 19's B2 timings), then runs
phases 22 and 23 (every check of the whole script included) and prints
their lines, B2's launches per table and the wall time.
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
        print("torch_mf_phases: no CUDA device", file=sys.stderr)
        return 1
    import ngsxfem_tpu_torch as T
    from ngsxfem_tpu_torch.kernels import build

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the allocator's statistics exist from here
    print(cs.card(), torch.__version__, torch.version.cuda, flush=True)
    build.build_all(["dia_cg", "ell_spmv"], {})
    print(f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    iso = [cs.iso_card(T, order, nx, dev, detail=False, keep=True)
           for order, nx in cs.ISO_BIG]
    print(f"phase 19's systems built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    launches, tables = cs.phases_22_23(T, dev, t0, iso)
    print(json.dumps({"launches_matrix_free": launches,
                      "matrix_free_tables": tables}))
    print(f"total {time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
