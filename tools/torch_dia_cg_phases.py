#!/usr/bin/env python3
"""Where an iteration of the port's cooperative DIA-PCG kernel spends its time.

    python3 tools/torch_dia_cg_phases.py [--nx 48 64 16] [--iters 50]

Run from the repository root on a machine with one CUDA card and ``nvcc``.
Builds ``ngsxfem_tpu_torch/csrc/dia_cg.cu`` with ``-DDIA_CG_PHASE_STAMPS``
into a temporary directory: thread 0 of every block then writes the global
timer at five points of each iteration (the window holds p_k; p.Ap reduced
in the block; alpha known; r.z reduced in the block; beta known).  For each
flagship size it runs PCG-``iters`` three times (x must equal the plain
version's), and prints one JSON line per size with the median over blocks
and iterations 5..iters-2 of each phase, in ns:
``spmv`` (window ready -> p.Ap reduced), ``exchange_a`` (-> alpha known),
``update`` (-> r.z reduced), ``exchange_b`` (-> beta known; the next window's
loads are in flight meanwhile), ``window_rest`` (-> next window ready), the
gaps from the last block's publication to alpha or beta being known
(``a_after_last``, ``b_after_last``), the spread of the blocks' publication
times of p.Ap (``a_spread``), and the whole iteration (``iteration``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from ngsxfem_tpu_torch.kernels import build, launch  # noqa: E402
from ngsxfem_tpu_torch.solvers import dia_cg  # noqa: E402


def load_stamped(tmp):
    src = os.path.join(build.CSRC, "dia_cg.cu")
    so = os.path.join(tmp, "libdia_cg_stamps.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                           "-DDIA_CG_PHASE_STAMPS", "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    entries = dict(dia_cg.LIB.entries,
                   set_stamps=("dia_cg_f32_set_stamps", (launch.PTR,)))
    return launch.Library("dia_cg", entries, prefix=dia_cg.LIB.prefix,
                          path=so)


def phases(lib, nx, iters, dev):
    _, struct, V, _, b, dinv, _ = cs.flagship(nx, dev)
    offs = struct["offsets"]
    plan = dia_cg.cuda_plan(offs, V.shape[1], dev)
    xp, _ = dia_cg.dia_cg_fused_plain(offs, V, b, dinv, iters)
    st = torch.zeros((64, 8, plan.grid), dtype=torch.int64, device=dev)
    lib.check("set_stamps", lib.fn("set_stamps")(st.data_ptr()))
    for _ in range(3):
        x, _ = dia_cg._dia_cg_cuda(offs, dia_cg._terms(offs), V, b, dinv,
                                   iters, lib=lib)
        torch.cuda.synchronize()
    cs.check(torch.equal(x, xp), f"nx={nx}: stamped kernel != plain")
    m = min(iters, 64)
    S = st.cpu().numpy()[:m, :6, :].astype(np.int64)  # [k, phase, block]
    body = slice(5, m - 1)  # steady iterations; the last skips exchange B

    def med(a, b_):
        return float(np.median(S[body, b_, :] - S[body, a, :]))

    out = {"spmv": med(1, 2), "exchange_a": med(2, 3), "update": med(3, 4),
           "exchange_b": med(4, 5),
           "window_rest": float(np.median(S[6:m, 1, :] - S[5:m - 1, 5, :])),
           "a_after_last": float(np.median(S[body, 3, :]
                                           - S[body, 2, :].max(1)[:, None])),
           "b_after_last": float(np.median(S[body, 5, :]
                                           - S[body, 4, :].max(1)[:, None])),
           "a_spread": float(np.median(S[body, 2, :].max(1)
                                       - S[body, 2, :].min(1))),
           "iteration": float(np.median(S[6:m, 1, :] - S[5:m - 1, 1, :]))}
    return {"card": cs.card(), "nx": nx, "n": int(V.shape[1]), "iters": iters,
            "plan": plan.describe(), "ns": out}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, nargs="+", default=[48, 64, 16])
    ap.add_argument("--iters", type=int, default=cs.CG_ITERS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.iters < 8:
        print("--iters must be >= 8", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        lib = load_stamped(tmp)
        for nx in args.nx:
            print(json.dumps(phases(lib, nx, args.iters, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
