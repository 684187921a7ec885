"""Run chip_smoke.py's space-time phases (20-21) alone on one CUDA card.

    python3 tools/torch_st_phases.py     (from the repository root)

Runs its phases 20 and 21 (the space-time path at the JAX tests' sizes,
card against CPU, and at card size with the per-slab clock, every check of
the whole script included) and prints their lines, the ell_spmv launches
of the path and the wall time.  The path runs no hand-written kernel, so
nothing is built.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_st_phases: no CUDA device", file=sys.stderr)
        return 1
    import ngsxfem_tpu_torch as T

    t0 = time.perf_counter()
    print(cs.card(), torch.__version__, torch.version.cuda, flush=True)
    launches = cs.phases_20_21(T, torch.device("cuda", 0), t0)
    print(f"ell_spmv launches on the space-time path: {launches}")
    print(f"total {time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
