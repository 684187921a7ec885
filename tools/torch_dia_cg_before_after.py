#!/usr/bin/env python3
"""Time the port's fused DIA-PCG kernel beside an earlier version of its source.

    python3 tools/torch_dia_cg_before_after.py OLD_DIA_CG_CU [--nx 48] [--iters 50]

Run from the repository root on a machine with one CUDA card and ``nvcc``.
OLD_DIA_CG_CU is an earlier ``ngsxfem_tpu_torch/csrc/dia_cg.cu`` with the
five-kernel C interface, ``dia_cg_f32(vals, n, n_terms, rows, offs, b, dinv,
iters, x, r, z, p, Ap, partials, scal, stream)`` and
``dia_cg_f32_num_partials(n)``: the five-kernel version, for example
``git show 3698942:ngsxfem_tpu_torch/csrc/dia_cg.cu``.  It is compiled with
the port's nvcc flags into a temporary directory; the current kernel builds
as usual.  On the flagship at ``--nx`` both versions
run in turns (old, new, new, old): each turn times PCG-``iters`` by CUDA
events (median of 5 after a warm-up) and by ``torch.profiler`` (device
kernels and device time per call, over 5 calls), and both x must agree with
``dia_cg_fused_plain`` within 5e-4.  Prints one JSON line, with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
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
from ngsxfem_tpu_torch.kernels import build  # noqa: E402
from ngsxfem_tpu_torch.solvers import dia_cg  # noqa: E402


def load_old(src, tmp):
    so = os.path.join(tmp, "libdia_cg_old.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.dia_cg_f32.restype = I
    lib.dia_cg_f32.argtypes = [P, I, I, P, P, P, P, I, P, P, P, P, P, P, P, P]
    lib.dia_cg_f32_num_partials.restype = I
    lib.dia_cg_f32_num_partials.argtypes = [I]
    return lib


def old_call(lib, offs, V, b, dinv, iters):
    terms = dia_cg._terms(offs)
    n = b.shape[0]
    rows = np.ascontiguousarray([k for k, _ in terms], dtype=np.int32)
    offa = np.ascontiguousarray([o for _, o in terms], dtype=np.int32)
    x = torch.empty_like(b)
    r, z, p, Ap = torch.empty((4, n), dtype=b.dtype, device=b.device)
    parts = torch.empty(lib.dia_cg_f32_num_partials(n), dtype=torch.float64,
                        device=b.device)
    scal = torch.empty(4, dtype=b.dtype, device=b.device)
    err = lib.dia_cg_f32(
        V.data_ptr(), n, len(terms), rows.ctypes.data, offa.ctypes.data,
        b.data_ptr(), dinv.data_ptr(), iters, x.data_ptr(), r.data_ptr(),
        z.data_ptr(), p.data_ptr(), Ap.data_ptr(), parts.data_ptr(),
        scal.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"old dia_cg_f32 failed with CUDA error {err}")
    return x, scal[3]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old_source")
    ap.add_argument("--nx", type=int, default=cs.NX)
    ap.add_argument("--iters", type=int, default=cs.CG_ITERS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _, struct, V, _, b, dinv, _ = cs.flagship(args.nx, dev)
    offs = struct["offsets"]
    xp, _ = dia_cg.dia_cg_fused_plain(offs, V, b, dinv, args.iters)
    with tempfile.TemporaryDirectory() as tmp:
        old = load_old(os.path.abspath(args.old_source), tmp)
        fns = {"old": lambda: old_call(old, offs, V, b, dinv, args.iters),
               "new": lambda: dia_cg.dia_cg_fused(offs, V, b, dinv, args.iters)}
        turns = []
        for name in ("old", "new", "new", "old"):
            x, _ = fns[name]()
            torch.cuda.synchronize()
            rel = float(torch.linalg.vector_norm(x - xp)
                        / torch.linalg.vector_norm(xp))
            cs.check(rel <= cs.KERNEL_TOL, f"{name}: rel {rel} vs plain")
            ms = cs.time_ms(fns[name])
            kern, wall_ms = cs.device_kernels(fns[name], 5)
            turns.append({
                "version": name, "ms": ms, "rel_vs_plain": rel,
                "device_kernels_per_call": sum(c for c, _ in kern.values()) / 5,
                "device_us_per_call": sum(us for _, us in kern.values()) / 5,
                "wall_ms_per_call": wall_ms / 5})
    print(json.dumps({"card": cs.card(), "nx": args.nx, "n": int(V.shape[1]),
                      "iters": args.iters,
                      "plan": dia_cg.cuda_plan(offs, V.shape[1], dev).describe(),
                      "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
