#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's flagship path once on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; one CUDA card, nvcc)

The flagship is 3D fictitious-domain Poisson with Nitsche terms and
facet-patch ghost penalty on a structured tet mesh at nx=48 (663,552 tets,
117,649 dofs, float32): ``UnfittedPoisson`` host setup -> ``dia_structure``
-> ``assemble_vals_lattice`` (DIA table) -> ``dia_cg_fused`` (the
hand-written CUDA kernel, 50 Jacobi-PCG iterations) -> ``cg_ir`` (converged
solve, true f64 residual <= 1e-10).  Phases, one line each:

1. environment: a CUDA card, its name and power limit from nvidia-smi;
2. build: compile csrc/dia_cg.cu with nvcc for sm_90a;
3. kernel against its plain PyTorch version on the card (nx=16 and 48,
   iters 1/12/50): rel ||x_k - x_p|| <= 5e-4, |res_k - res_p| <= 5e-4 ||b||,
   two kernel runs bitwise equal, an asymmetric offset set raises;
4. the main path at nx=48 with the launch counter reset before it, then
   checks of mesh size, ncut, DIA symmetry, residuals, kernel vs
   ``krylov.cg`` + ``dia_matvec``, and the ``cg_ir`` residual;
5. times on the card with CUDA events (one warm-up, median of 5).

Every failed check raises, so the script exits non-zero.  It imports nothing
of JAX.  The line before the last is the kernel record
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

NX = 48
CG_ITERS = 50
IR_OUTER, IR_INNER = 4, 120
KERNEL_TOL = 5e-4     # f32 kernel vs plain (the reference's on-hardware bound)
SOLVE_TOL = 1e-10     # true f64 relative residual of cg_ir


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def flagship(nx, device):
    """Model, DIA structure, table, ncut, rhs, Jacobi inverse diagonal and
    host-setup seconds, built as bench.py builds the reference's flagship."""
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson

    t0 = time.perf_counter()
    model = UnfittedPoisson(nx=nx, dim=3, order=1, dtype=torch.float32,
                            device=device)
    struct = model.dia_structure()
    setup_s = time.perf_counter() - t0
    V, ncut = model.assemble_vals_lattice(model.vertices, model.lset, struct)
    k0 = int(np.searchsorted(struct["offsets"], 0))
    b = torch.as_tensor(np.where(model.active_dofs[struct["perm_inv"]], 1.0, 0.0),
                        dtype=torch.float32, device=device)
    dinv = torch.where(V[k0].abs() > 1e-30, 1.0 / V[k0], 1.0)
    return model, struct, V, ncut, b, dinv, setup_s


def is_symmetric(V, offsets):
    Vn = V.cpu().numpy()
    n = Vn.shape[1]
    offs = np.asarray(offsets)
    return all(np.array_equal(Vn[k][:n - o], Vn[int(np.flatnonzero(offs == -o)[0])][o:])
               for k, o in enumerate(offs) if o > 0)


def time_ms(fn, reps=5):
    """Median CUDA-event time of `fn` in ms, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.median(ts)


def main():
    # 1. environment
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from ngsxfem_tpu_torch.kernels import build
    from ngsxfem_tpu_torch.solvers import dia_cg
    from ngsxfem_tpu_torch.solvers.krylov import cg, cg_ir
    from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

    gpu = card()
    dev = torch.device("cuda", 0)
    print(f"[1 env] {gpu} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| devices {torch.cuda.device_count()}", flush=True)

    # 2. build
    so, build_s, log = build.build("dia_cg")
    regs = sorted({ln.split("Used ")[1].split(" registers")[0]
                   for ln in log.splitlines() if "registers" in ln})
    print(f"[2 build] csrc/dia_cg.cu -> {so.rsplit('/', 1)[-1]} in {build_s:.2f} s "
          f"(registers per kernel: {', '.join(regs) or 'reused build'})", flush=True)

    # 3. kernel against its plain version on the card
    before = dia_cg.launches
    max_abs_err = 0.0
    worst_rel = 0.0
    for nx in (16, NX):
        _, struct, V, _, b, dinv, _ = flagship(nx, dev)
        offs = struct["offsets"]
        bn = float(torch.linalg.vector_norm(b))
        for iters in (1, 12, CG_ITERS):
            xk, rk = dia_cg.dia_cg_fused(offs, V, b, dinv, iters)
            xk2, rk2 = dia_cg.dia_cg_fused(offs, V, b, dinv, iters)
            xp, rp = dia_cg.dia_cg_fused_plain(offs, V, b, dinv, iters)
            torch.cuda.synchronize()
            rel = float(torch.linalg.vector_norm(xk - xp)
                        / torch.linalg.vector_norm(xp).clamp_min(1e-30))
            check(rel <= KERNEL_TOL, f"nx={nx} iters={iters}: rel {rel}")
            check(abs(float(rk) - float(rp)) <= KERNEL_TOL * bn,
                  f"nx={nx} iters={iters}: res {float(rk)} vs {float(rp)}")
            check(torch.equal(xk, xk2) and torch.equal(rk, rk2),
                  f"nx={nx} iters={iters}: two kernel runs differ")
            worst_rel = max(worst_rel, rel)
            if nx == NX and iters == CG_ITERS:
                max_abs_err = float((xk - xp).abs().max())
    try:
        dia_cg.dia_cg_fused([-1, 0, 2], V[:3], b, dinv, 1)
    except ValueError:
        pass
    else:
        raise RuntimeError("check failed: asymmetric offsets did not raise")
    check(dia_cg.launches > before, "kernel launch counter did not move")
    print(f"[3 kernel] nx=16,{NX} iters=1,12,{CG_ITERS}: worst rel "
          f"{worst_rel:.3e} <= {KERNEL_TOL}, bitwise repeatable, "
          f"max|x_k - x_p| at nx={NX} iters={CG_ITERS} = {max_abs_err:.3e}, "
          f"asymmetric offsets raise", flush=True)
    del V, b, dinv

    # 4. the main path, launch counter reset just before it
    dia_cg.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, struct, V, ncut, b, dinv, setup_s = flagship(NX, dev)
    offs = struct["offsets"]
    x, res = dia_cg.dia_cg_fused(offs, V, b, dinv, CG_ITERS)
    V64 = V.double()
    mv32 = lambda v: dia_matvec(offs, V, v)
    mv64 = lambda v: dia_matvec(offs, V64, v)
    x64, res64 = cg_ir(mv32, mv64, b, M=lambda r: dinv * r,
                       outer=IR_OUTER, inner=IR_INNER)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dia_cg.launches
    check(launches > 0, "the main path launched the dia_cg kernel no time")

    check(model.mesh.ne == 663_552 and model.ndof == 117_649,
          f"mesh size ne={model.mesh.ne} ndof={model.ndof}")
    lset = model.lset.cpu().numpy()
    lset = np.where(np.abs(lset) < 1e-14, np.float32(1e-14), lset)
    lv = lset[model.elements]  # eps-guarded as the reference guards it
    ncut_host = int(((lv < 0).any(1) & (lv > 0).any(1)).sum())
    check(int(ncut) == ncut_host, f"ncut {int(ncut)} != host count {ncut_host}")
    check(is_symmetric(V, offs), "DIA table is not exactly symmetric")
    bn = float(torch.linalg.vector_norm(b))
    rel50 = float(res) / bn
    _, res1 = dia_cg.dia_cg_fused(offs, V, b, dinv, 1)
    rel1 = float(res1) / bn
    check(np.isfinite(rel50) and rel50 < rel1,
          f"PCG-{CG_ITERS} residual {rel50} not below 1-iteration {rel1}")
    xr, _, _ = cg(mv32, b, M=lambda r: dinv * r, maxiter=CG_ITERS, tol=0.0)
    rel_cg = float(torch.linalg.vector_norm(x - xr)
                   / torch.linalg.vector_norm(xr).clamp_min(1e-30))
    check(rel_cg <= KERNEL_TOL, f"kernel x vs krylov.cg: rel {rel_cg}")
    ir_rel = float(res64) / float(torch.linalg.vector_norm(b.double()))
    check(ir_rel <= SOLVE_TOL, f"cg_ir true f64 relative residual {ir_rel}")
    print(f"[4 main] nx={NX} ne={model.mesh.ne} ndof={model.ndof} ncut={int(ncut)} "
          f"(host {ncut_host}), DIA {tuple(V.shape)} exactly symmetric, "
          f"PCG-{CG_ITERS} rel res {rel50:.4e} (1 iter {rel1:.4e}), kernel vs "
          f"krylov.cg rel {rel_cg:.3e}, cg_ir true f64 rel res {ir_rel:.3e}, "
          f"dia_cg launches {launches}, wall {main_s:.2f} s", flush=True)

    # 5. times on the card
    asm_ms = time_ms(lambda: model.assemble_vals_lattice(model.vertices,
                                                         model.lset, struct))
    pcg_ms = time_ms(lambda: dia_cg.dia_cg_fused(offs, V, b, dinv, CG_ITERS))
    plain_ms = time_ms(lambda: dia_cg.dia_cg_fused_plain(offs, V, b, dinv,
                                                         CG_ITERS))
    cg_ms = time_ms(lambda: cg(mv32, b, M=lambda r: dinv * r,
                               maxiter=CG_ITERS, tol=0.0))
    ir_ms = time_ms(lambda: cg_ir(mv32, mv64, b, M=lambda r: dinv * r,
                                  outer=IR_OUTER, inner=IR_INNER))
    eps = model.mesh.ne / ((asm_ms + pcg_ms) / 1e3)
    print(f"[5 times] {card()} | host setup {setup_s:.3f} s | assembly "
          f"{asm_ms:.3f} ms | PCG-{CG_ITERS} kernel {pcg_ms:.3f} ms | "
          f"PCG-{CG_ITERS} plain (dia_cg_fused_plain) {plain_ms:.3f} ms | "
          f"PCG-{CG_ITERS} krylov.cg+dia_matvec {cg_ms:.3f} ms | cg_ir "
          f"{ir_ms:.3f} ms | assembly+PCG-{CG_ITERS} {eps:.4g} elements/s",
          flush=True)

    print(json.dumps({"kernels": [{
        "name": "dia_cg_fused",
        "route": "cuda",
        "source": "ngsxfem_tpu_torch/csrc/dia_cg.cu",
        "replaces": "ngsxfem_tpu/solvers/pallas_cg.py:159",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": pcg_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
