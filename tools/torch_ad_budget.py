"""The flagship compliance J(r) = b^T x of chip_smoke.py's phase 26 at
nx=48 (f64) through a fixed Jacobi-PCG budget of 20, 50, 80 and 120 steps,
on one CUDA card.

    python3 tools/torch_ad_budget.py     (from the repository root)

For each budget: J and dJ/dr (autograd) by the lattice path (lattice
assembly + ``dia_matvec`` + unrolled ``krylov.cg``) and by the general path
(``assemble_vals_soa1`` + ELL products through kernel B2 under autograd),
both ``chip_smoke.compliance_fns``, and their relative differences; the
general path against itself with its ELL rows' slots in a seeded order and
at r0 + 1 ulp (rounding-sized changes of one path); central differences of
the lattice path at four steps.  It shows where rounding grows (the PCG's
plateau) and the central difference's eps^2 term; chip_smoke.py chooses
its budget and step from it.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

BUDGETS = (20, 50, 80, 120)
STEPS = (2.5e-7, 5e-7, 1e-6, 2e-6)


def main():
    if not torch.cuda.is_available():
        print("torch_ad_budget: no CUDA device", file=sys.stderr)
        return 1
    from ngsxfem_tpu_torch.kernels import build
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson

    dev = torch.device("cuda", 0)
    print(cs.card(), flush=True)
    build.build_all(["ell_spmv"])
    m = UnfittedPoisson(nx=cs.AD_NX, dim=3, order=1, dtype=torch.float64,
                        device=dev)
    dst, st = m.dia_structure(), m.ell_structure()
    r0, gap = cs.ad_r0(m)
    k_order = np.random.default_rng(2033).permutation(st["ell_cols"].shape[1])
    r_ulp = float(np.nextafter(r0, 1.0))

    def rel(a, b):
        return abs(a - b) / abs(b)

    print(f"nx={cs.AD_NX}: r0 {r0:.15f}, vertex gap {gap:.3e}", flush=True)
    for it in BUDGETS:
        t0 = time.perf_counter()
        lattice, general = cs.compliance_fns(m, dst, st, it, dev)
        _, general_slots = cs.compliance_fns(m, dst, st, it, dev, k_order)
        jl, gl = cs._value_and_grad(lattice, r0, dev)
        jg, gg = cs._value_and_grad(general, r0, dev)
        js, gs = cs._value_and_grad(general_slots, r0, dev)
        ju, gu = cs._value_and_grad(general, r_ulp, dev)
        with torch.no_grad():
            fds = {e: (float(lattice(r0 + e)) - float(lattice(r0 - e)))
                   / (2 * e) for e in STEPS}
        print(f"PCG-{it}: J lattice {jl:.15e} general {jg:.15e} (rel "
              f"{rel(jl, jg):.3e}); dJ/dr lattice {gl:.12e} general "
              f"{gg:.12e} (rel {rel(gl, gg):.3e}); general against itself, "
              f"rel in J / in dJ/dr: ELL slots reordered {rel(js, jg):.3e} "
              f"/ {rel(gs, gg):.3e}, r0 + 1 ulp {rel(ju, jg):.3e} / "
              f"{rel(gu, gg):.3e}; dJ/dr / J {gl / jl:.1f}; central "
              f"differences: "
              + ", ".join(f"eps {e:g} rel {rel(gl, v):.2e}"
                          for e, v in fds.items())
              + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
