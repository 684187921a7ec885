"""Run chip_smoke.py's phase 31 (the functional layer from numpy inputs:
kernel B1 with the reference's ``plane``, kernel B2 through ``krylov.cg``,
``minres`` and ``cg_ir``, ``dia_matvec`` and the lattice transfers) alone
on one CUDA card.

    python3 tools/torch_numpy_phase.py     (from the repository root)

Builds kernels B1 and B2 as chip_smoke.py does, builds the flagship
(``UnfittedPoisson`` P1 f32 at nx=48: its DIA table, b and dinv, and its
ELL table and indicator rhs, as phases 4 and 7 of the whole script build
them), then runs phase 31 (every check of the whole script included) and
prints its lines, the launches and the wall time.
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
        print("torch_numpy_phase: no CUDA device", file=sys.stderr)
        return 1
    from ngsxfem_tpu_torch.kernels import build

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    print(cs.card(), torch.__version__, torch.version.cuda, flush=True)
    build.build_all(["dia_cg", "ell_spmv"])
    print(f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    system = cs.phase_31_system(cs.NX, dev)
    cs.sync(dev)
    print(f"flagship nx={cs.NX} DIA and ELL tables in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out = cs.phase_31(dev, *system, t0)
    print(json.dumps({"launches_slice16": out["ell_spmv"],
                      "dia_cg_launches": out["dia_cg"],
                      "cases": out["cases"]}))
    print(f"total {time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
