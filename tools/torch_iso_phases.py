"""Run chip_smoke.py's isoparametric phases (18-19) alone on one CUDA card.

    python3 tools/torch_iso_phases.py     (from the repository root)

Builds the kernels as chip_smoke.py does, then runs its phases 18 and 19
(the isoparametric path at the JAX tests' sizes and at card size, every
check of the whole script included) and prints their lines, the B2 records
of the new tables and the wall time.
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
        print("torch_iso_phases: no CUDA device", file=sys.stderr)
        return 1
    import ngsxfem_tpu_torch as T
    from ngsxfem_tpu_torch.kernels import build

    t0 = time.perf_counter()
    print(cs.card(), torch.__version__, torch.version.cuda, flush=True)
    build.build_all(["dia_cg", "ell_spmv", "ell_spmv_rowmajor"],
                    {"ell_spmv_rowmajor": os.path.join(
                        cs.TOOLS, "torch_ell_spmv_rowmajor.cu")})
    print(f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    iso, _ = cs.phases_18_19(T, torch.device("cuda", 0), t0)
    print(json.dumps([dict(cs.b2_record(b["b2"]), launches=b["launches"])
                      for b in iso]))
    print(f"total {time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
