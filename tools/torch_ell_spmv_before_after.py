#!/usr/bin/env python3
"""Time the port's sliced-ELL kernel beside the row-major kernel it replaced.

    python3 tools/torch_ell_spmv_before_after.py [OLD_ELL_SPMV_CU] [--turns 2]

Run from the repository root on a machine with one CUDA card and ``nvcc``.
OLD_ELL_SPMV_CU (default ``tools/torch_ell_spmv_rowmajor.cu``, the port's
kernel as of commit d41764a) is a one-thread-per-row ELL kernel with the C
interface ``ell_spmv_f32/f64(vals, cols, x, y, n, K, stream)`` over the
row-major ``(n, K)`` table; it is compiled with the port's nvcc flags into
``build/kernels/``, the current kernel as usual.  On the six tables of
``chip_smoke.py`` (the flagship's assembled ELL table at nx=48 in f32, the
``examples.fictdom3d`` forms table at nx=48 and the ``fictdom_dg_ghostpen``,
``fictdom_dn_ghostpen``, ``nxfem`` nx=256 and ``stokescutfem`` nx=128
tables, f64) the two kernels run in turns (old, new, new, old, ``--turns``
times): device us per launch by ``torch.profiler`` over 50 launches after
200 to warm the card up, on a seeded x, and both results equal to
``ell_matvec_plain`` (``torch.equal``).
Prints one line per table and one JSON line, with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWMAJOR_SRC = os.path.join(ROOT, "tools", "torch_ell_spmv_rowmajor.cu")
_OLD = {}


def load_rowmajor(src=ROWMAJOR_SRC):
    """Build (once, into build/kernels/) and load the row-major kernel."""
    lib = _OLD.get(src)
    if lib is None:
        from ngsxfem_tpu_torch.kernels import build

        so, _, _ = build.build("ell_spmv_rowmajor", src)
        lib = _OLD[src] = ctypes.CDLL(so)
        P, I = ctypes.c_void_p, ctypes.c_int
        for name in ("ell_spmv_f32", "ell_spmv_f64"):
            getattr(lib, name).restype = I
            getattr(lib, name).argtypes = [P, P, P, P, I, I, P]
    return lib


def rowmajor_matvec(lib, vals, cols, x):
    """y = the row-major kernel on the (n, K) table, on the current stream."""
    n, K = vals.shape
    y = torch.empty(n, dtype=vals.dtype, device=vals.device)
    fn = lib.ell_spmv_f32 if vals.dtype == torch.float32 else lib.ell_spmv_f64
    err = fn(vals.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
             n, K, torch.cuda.current_stream(vals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row-major ell_spmv launch failed: error {err}")
    return y


def device_us(fn, kernel, calls=50, warm=200):
    """Device us per launch of the kernels whose name holds ``kernel``,
    by torch.profiler over ``calls`` calls of ``fn`` after ``warm`` calls
    (which bring the card from its idle clock to its load clock)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", getattr(evt, "cuda_time_total", 0))
        if kernel in evt.key and evt.count:
            return us / evt.count
    raise RuntimeError(f"no device kernel named *{kernel}* in the profile")


OLD_KERNEL = "ell_spmv_kernel"      # the row-major kernel's device name
NEW_KERNEL = "sell32_spmv_kernel"   # csrc/ell_spmv.cu's


def tables(dev):
    """[(label, ELLMatrix)] of the six tables, built as chip_smoke.py
    builds them."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ngsxfem_tpu_torch.examples import (fictdom3d, fictdom_dg_ghostpen,
                                            fictdom_dn_ghostpen, nxfem,
                                            stokescutfem)
    from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix

    out = []
    model = cs.flagship(cs.NX, dev)[0]
    st = model.ell_structure()
    V, _ = model.assemble_vals_soa1(model.vertices, model.lset, st)
    out.append((f"flagship ELL nx={cs.NX} f32", ELLMatrix(
        torch.as_tensor(st["ell_cols"], device=dev), V,
        (model.ndof, model.ndof))))
    del model
    for label, build in (
            (f"fictdom3d forms nx={cs.API_NX[-1]}",
             lambda: fictdom3d.system(nx=cs.API_NX[-1], device=dev)),
            ("fictdom_dg_ghostpen nx=256",
             lambda: fictdom_dg_ghostpen.system(nx=256, order=2, device=dev)),
            ("fictdom_dn_ghostpen nx=256",
             lambda: fictdom_dn_ghostpen.system(nx=256, order=1, device=dev)),
            ("stokescutfem nx=128",
             lambda: stokescutfem.system(nx=128, device=dev)),
            ("nxfem nx=256", lambda: nxfem.system(nx=256, device=dev))):
        a = build()[0]
        a.Assemble()
        out.append((label, a.mat.ell()))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", nargs="?", default=ROWMAJOR_SRC)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ngsxfem_tpu_torch.solvers import ell_spmv

    dev = torch.device("cuda", 0)
    gpu = cs.card()
    old = load_rowmajor(args.old)
    rows = []
    for label, A in tables(dev):
        n, K = A.vals.shape
        L = A.layout()
        x = torch.as_tensor(np.random.default_rng(2031).standard_normal(
            A.shape[1]), dtype=A.vals.dtype, device=dev)
        y_plain = ell_spmv.ell_matvec_plain(A.vals, A.cols, x)
        y_old = rowmajor_matvec(old, A.vals, A.cols, x)
        y_new = A @ x
        torch.cuda.synchronize()
        cs.check(torch.equal(y_old, y_plain), f"{label}: old kernel != plain")
        cs.check(torch.equal(y_new, y_plain), f"{label}: new kernel != plain")
        t_old, t_new = [], []
        for _ in range(args.turns):
            t_old.append(device_us(
                lambda: rowmajor_matvec(old, A.vals, A.cols, x), OLD_KERNEL))
            t_new.append(device_us(lambda: A @ x, NEW_KERNEL))
            t_new.append(device_us(lambda: A @ x, NEW_KERNEL))
            t_old.append(device_us(
                lambda: rowmajor_matvec(old, A.vals, A.cols, x), OLD_KERNEL))
        s = A.vals.element_size()
        row = {"table": label, "n": int(n), "K": int(K),
               "dtype": str(A.vals.dtype)[6:], "nnz": L.nnz,
               "slice_fill": L.fill, "old_us": t_old, "new_us": t_new,
               "old_median_us": statistics.median(t_old),
               "new_median_us": statistics.median(t_new),
               "bound_padded_us": cs.ell_bound(n, K, A.shape[1], s)[0] * 1e3,
               "bound_nnz_us": cs.nnz_bound(L.nnz, n, A.shape[1], s)[0] * 1e3}
        rows.append(row)
        print(f"[before/after] {gpu} | {label} ({n} x {K} {row['dtype']}, "
              f"{L.nnz} real slots, slice fill {L.fill:.4f}): old "
              f"{row['old_median_us']:.3f} us, new {row['new_median_us']:.3f}"
              f" us device per launch (turns old {[round(t, 3) for t in t_old]}"
              f", new {[round(t, 3) for t in t_new]}); bounds padded "
              f"{row['bound_padded_us']:.3f} us, nnz "
              f"{row['bound_nnz_us']:.3f} us", flush=True)
        del A, L, x, y_plain, y_old, y_new
    print(json.dumps({"card": gpu, "tables": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
