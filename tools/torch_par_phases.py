"""Run chip_smoke.py's parallel-layout and assembly-route phases (28-29)
alone on one CUDA card.

    python3 tools/torch_par_phases.py     (from the repository root)

Builds the ELL kernel B2 and the row-major kernel it replaced (B2's timings
set them side by side) as chip_smoke.py does, builds the f32 and f64
flagships at nx=48 (chip_smoke.py reuses phases 4 and 13's) and the ELL
structure, then runs phases 28 (``dryrun_multichip`` on every card through
spawned NCCL ranks, the layouts at world size 1 through NCCL, the
public-API flagship's operators and solve on a sharded mesh) and 29 (every
check of the whole script included) and prints their lines, B2's launches
and the wall time.
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
        print("torch_par_phases: no CUDA device", file=sys.stderr)
        return 1
    from ngsxfem_tpu_torch.kernels import build
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    print(cs.card(), torch.__version__, torch.version.cuda, flush=True)
    build.build_all(["ell_spmv", "ell_spmv_rowmajor"],
                    {"ell_spmv_rowmajor": os.path.join(
                        cs.TOOLS, "torch_ell_spmv_rowmajor.cu")})
    print(f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    flagships = {}
    for dt in (torch.float32, torch.float64):
        m = UnfittedPoisson(nx=cs.NX, dim=3, order=1, dtype=dt, device=dev)
        d = m.dia_structure()
        V, _ = m.assemble_vals_lattice(m.vertices, m.lset, d)
        flagships[dt] = (m, d, V)
    st = flagships[torch.float64][0].ell_structure()
    print(f"flagships and structures in {time.perf_counter() - t0:.2f} s",
          flush=True)
    launches, b2, _, _, (_, sh) = cs.phases_28_29(dev, t0, flagships, st)
    print(json.dumps({"launches_slice13": launches,
                      "slice13_tables": [dict(cs.b2_record(b2),
                                              launches=launches)],
                      "launches_slice14": sh["launches"]}))
    print(f"total {time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
