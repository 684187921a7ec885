#!/usr/bin/env python3
"""Repeat the port's ELL path (chip_smoke.py phase 7) and its MG-CG solve.

    python3 tools/torch_mg_repeat.py [--reps 4] [--deterministic]

Run from the repository root on a machine with one CUDA card and ``nvcc``.
Builds the nx=48 flagship once, then ``--reps`` times assembles the ELL
levels nx = 12, 24, 48 anew (``chip_smoke.ell_path``) and solves MG-CG to
1e-8, then solves the same operator twice more.  With ``--deterministic``
the levels are assembled under ``torch.use_deterministic_algorithms``.
Prints one line per assembly: MG-CG iterations and recursion relative
residual of each solve, and a checksum of the finest ELL table, so that the
run shows whether the spread comes from the assembly or from the solve.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from ngsxfem_tpu_torch.solvers import dia_cg  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    model, struct, V, _, b, dinv, _ = cs.flagship(cs.NX, dev)
    x, _ = dia_cg.dia_cg_fused(struct["offsets"], V, b, dinv, cs.CG_ITERS)
    print(cs.card(), f"deterministic={args.deterministic}", flush=True)
    for rep in range(args.reps):
        torch.use_deterministic_algorithms(args.deterministic)
        try:
            ell = cs.ell_path(dev, model, dict(struct, V=V), x)
        finally:
            torch.use_deterministic_algorithms(False)
        bn = float(torch.linalg.vector_norm(ell["b"]))
        solves = [(ell["iters"], float(ell["res"]) / bn)]
        for _ in range(2):
            _, iters, res = ell["mgcg"]()
            solves.append((iters, float(res) / bn))
        Vf = ell["levels"][-1]["V"].double()
        w = torch.arange(Vf.numel(), device=dev, dtype=torch.float64)
        print(f"assembly {rep}: MG-CG (iterations, rel res) "
              + ", ".join(f"({i}, {r:.3e})" for i, r in solves)
              + f"; finest table checksum {float((Vf.reshape(-1) * w).sum()):.17g}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
