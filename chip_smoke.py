#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's flagship paths once on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; one CUDA card, nvcc)

The flagship is 3D fictitious-domain Poisson with Nitsche terms and
facet-patch ghost penalty on a structured tet mesh at nx=48 (663,552 tets,
117,649 dofs, float32).  Three paths run through it (and general cut
quadrature, phase 9, beside it), two more in phases 12-15, and the
skeleton, vector and XFEM workloads in phases 16-17:

- the DIA path: ``UnfittedPoisson`` host setup -> ``dia_structure`` ->
  ``assemble_vals_lattice`` (DIA table) -> ``dia_cg_fused`` (hand-written
  CUDA kernel, 50 Jacobi-PCG iterations) -> ``cg_ir`` (converged solve, true
  f64 residual <= 1e-10);
- the ELL path: ``ell_structure`` -> ``assemble_vals_soa1`` (ELL table) on
  nx = 12, 24, 48 -> ``ELLMatrix`` / ``ell_matvec`` (hand-written CUDA
  kernel) -> Jacobi-CG-50 through ``CGSolver`` -> ``FunctionalELLMG``
  (cut multigrid, ``prepare_host``) as the preconditioner of ``krylov.cg``
  to 1e-8;
- the quadrature path: ``UnfittedPoisson.elmats`` / ``apply`` / ``rhs`` /
  ``solve`` from cut quadrature rules (no hand-written kernel: no TPU
  kernel lies on this path);
- the lattice multigrid on the DIA path: ``LatticeDIAMG`` on the DIA tables
  of nx = 12, 24, 48 as the preconditioner of ``krylov.cg`` (f32 and f64;
  plain PyTorch: the reference has no TPU kernel there), and the flagship
  in native f64;
- the public API: ``examples.fictdom3d`` (the flagship written as a weak form
  through ``BilinearForm``/``LinearForm``), solved by the named host LU
  (``inverse="umfpack"``), by ``a.mat.Inverse(freedofs, inverse="cg")`` and
  by the default ``a.mat.Inverse(freedofs)``, both of which run Jacobi-CG
  through the ``ell_matvec`` kernel on the card;
- the skeleton, vector and XFEM workloads: ``examples.fictdom_dg_ghostpen``
  (L2, cut-facet interior penalty), ``fictdom_dn_ghostpen`` (``dnjump``
  skeleton ghost penalty), ``stokescutfem`` (``VectorH1``, ``div``, a
  saddle-point system solved by ``MinResSolver``), ``nxfem`` (XFESpace)
  and ``xfespaces``, their systems' products all through ``ell_matvec``.

Phases, one line each:

1. environment: a CUDA card, its name and power limit from nvidia-smi;
2. build: compile csrc/dia_cg.cu, csrc/ell_spmv.cu and the row-major ELL
   kernel B2 replaced (tools/torch_ell_spmv_rowmajor.cu, the "before" of
   B2's times) with nvcc for sm_90a, all at once; B2's registers, shared
   memory and local memory (spills);
3. DIA-PCG kernel (one persistent cooperative kernel per call) against its
   plain PyTorch version on the card: the flagship at nx=16, 48 and 64 and
   seeded random exactly symmetric tables (1D, 2D and 3D lattice offsets,
   n = 1 / 257 / 100,003, and two large ones whose launch plan stages only
   part of the operator), iters 0/1/12/50: rel ||x_k - x_p|| <= 5e-4,
   |res_k - res_p| <= 5e-4 ||b||, two kernel runs bitwise equal, an
   asymmetric offset set raises; prints the launch plan at nx=48 and 64;
4. the DIA path at nx=48 with the launch counters reset before it, then
   checks of mesh size, ncut, DIA symmetry, residuals, kernel vs
   ``krylov.cg`` + ``dia_matvec``, and the ``cg_ir`` residual;
5. DIA-path times on the card with CUDA events (one warm-up, median of 5),
   and ``torch.profiler`` on PCG-50 calls: exactly one ``dia_cg`` device
   kernel per call, device time per iteration (t(50) - t(0)) / 50;
6. ELL kernel (SELL-32-1024 layout from ``prepare_ell``) against its plain
   PyTorch versions on the card: the nx=48 ELL table in f32 and f64 and
   seeded tables (K = 1..64, n = 0, 1, 31, 32, 33, 257, 100,003, row
   lengths varying inside each slice, all-padding rows, a NaN-poisoned
   table that stays NaN): == ``sell_matvec_plain`` bit for bit, ==
   ``ell_matvec_plain`` under ``torch.equal``, bitwise repeatable; int64
   cols, a wrong shape, a CPU x and a layout of another table raise; a raw
   call builds its own layout; the nx=48 table's slice_K statistics and
   slice fill;
7. the ELL path at nx=48 with the launch counters reset before it, its
   tables assembled as a user's call assembles them (fixed-order sums, no
   global flag): ELL operator == DIA operator after the dof renumbering
   (rel <= 1e-5), Jacobi-CG-50 on ELL == the DIA-PCG kernel's x (rel
   <= 5e-4), MG-CG on [12, 24, 48] to rel res <= 1e-8 in <= 16 iterations
   with a true f64 relative residual <= 1e-4, the solve's layouts == its
   tables (built in ``prepare_host``, none per product), ELL-kernel
   launches > 0; then the nx=48 table assembled five more times: bitwise
   equal, MG-CG in the same number of iterations each time;
8. ELL-path times on the card: SpMV kernel per call (mean of 100) and
   device time per launch, the row-major kernel it replaced, its plain
   versions, ``torch.sparse_csr_tensor @ x`` (cuSPARSE, a yardstick only),
   the nnz bound (the record's ``bound_ms``) and the padded one, assembly
   per level, ``prepare_host``, MG-CG;
9. general cut quadrature through ``Integrate`` on the card, f64: the
   reference suite's exactness cases (error <= 5e-15 (k+1)^2, the plane on
   256 x 256 meshes to 1e-12), the ball r=0.4 on tets nx = 16, 32, 64 and
   hexes nx = 12, 24, 48 (order 4, NEG volume and IF area EOC >= 1.75,
   NEG + POS = 1, element_wise sums), f32 vs f64 at tets nx=64 (rel
   <= 1e-5), the README's Quick start, the autograd dV/dr of the ball
   (against 4 pi r^2 and a central difference) and ``CutInfo`` at tets
   nx=64 against a host sign count;
10. the quadrature path of the flagship at nx=48: ``apply`` == the DIA
   operator of ``assemble_vals_lattice`` (f64 rel <= 1e-11, f32 <= 1e-5),
   ``rhs`` against ``Integrate`` over NEG (1e-12), ``solve()`` in f32 (its
   recursion residual within 1e-2 of the true f64 residual), and the
   symmetry of the order-2 operator at nx=24 (<= 1e-6, f32);
11. times of ``Integrate``, ``CutInfo``, ``elmats``, ``apply``, the
   operator's matvec and ``solve()`` with CUDA events and
   ``torch.profiler`` (device kernels, busy time, idle share), and the
   peak memory of phases 9-11;
12. lattice multigrid on the DIA path: levels nx = 12, 24, 48 in f32 and
   f64 (``prepare_safe``, which raises on a bad coarse inverse; its residual
   <= 1e-3), MG-CG to rel res <= 1.5e-8 in <= 12 iterations (10 measured),
   true f64 relative residual <= 1e-4 (f32) / 1e-7 (f64), fewer than half the
   iterations of Jacobi-CG; the f32 table bitwise equal over five
   assemblies; the hierarchy nx = 16, 32, 64 once;
13. native f64: the f64 lattice table at nx=48 within 2e-5 max|V| of the f32
   one and exactly symmetric, f64 Jacobi-PCG and ``cg_ir`` both to a true
   relative residual <= 1e-10, solutions equal to 1e-8 relative;
14. the public API, launch counters reset before it: ``examples.fictdom3d``
   at nx = 8, 12, 24, 48 (nx=8 error < 0.06, EOC >= 1.75; nx=48 is built
   once through ``examples.fictdom3d.system``), there the ELL kernel against
   its plain versions on the forms-assembled table (117,649 x 24, f64) with
   a seeded x and the free-masked load, bitwise, and its times as in phase
   8; the named direct (``inverse="umfpack"``), the ``"cg"`` and the
   default ``Inverse()`` solve (on the card: Jacobi-CG, path
   ``"device_cg"``, its wall time beside the LU's) equal to 1e-8 with
   ``ell_spmv`` launches equal to the CGs' products and one layout built
   for the table, ``a.mat`` symmetric to 1e-12, the same three
   integrators on ``UnfittedPoisson``'s mesh against its DIA operator on
   active dofs (f64, rel <= 1e-12), ``examples.fictdom_ghostpen`` (nx=40) and
   ``examples.cutfem`` (nx=30, L2 ~0.0188) within 1e-8 of their CPU runs;
15. times of phases 12-14 with CUDA events and ``torch.profiler`` (device
   kernels, busy time, idle share, kernels per MG-CG iteration) and their
   peak memory;
16. the skeleton, vector and XFEM workloads, launch counters reset before
   them, f64: ``fictdom_dg_ghostpen`` (order 2) at nx = 20, 40,
   ``fictdom_dn_ghostpen`` at nx=20, ``nxfem`` at nx=15 and ``xfespaces``
   on the card (whose default ``Inverse()`` now solves on the device but
   for Stokes) against the CPU (host LU) to 1e-8 with the reference tests'
   limits; ``nxfem`` nx=64 ``"cg"`` vs the named host LU (1e-8);
   ``stokescutfem`` at nx=16 (limits) and nx=32 (convergence;
   ``MinResSolver`` with the example's block preconditioner vs the named
   host LU, velocity and errors to 1e-8); then each
   at its card size (DG, dn and nxfem nx=256 through ``Inverse(free,
   inverse="cg")``, Stokes nx=128 through ``MinResSolver``), built once
   through ``system()``: kernel B2 == plain bitwise on each table (a seeded
   x, the free-masked load) with its times as in phase 8, ``ell_spmv``
   launches == the solver's products == iterations + 1, one layout built
   per solve, true relative residual <= 1e-8, L2 errors below the smaller
   sizes';
17. the card-size calls of phase 16: ``Assemble`` by CUDA events and under
   ``torch.profiler`` (device kernels, busy, idle share, host seconds),
   ``to_ell`` (host), each solve over a window of 100 iterations, peak
   memory.

Every failed check raises, so the script exits non-zero.  It imports nothing
of JAX.  The line before the last is the kernel record
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

NX = 48
KERNEL_NX = (16, 48, 64)  # flagship sizes of phase 3
KERNEL_ITERS = (0, 1, 12, 50)
CG_ITERS = 50
IR_OUTER, IR_INNER = 4, 120
KERNEL_TOL = 5e-4     # f32 kernel vs plain (the reference's on-hardware bound)
SOLVE_TOL = 1e-10     # true f64 relative residual of cg_ir
MG_NX = (12, 24, 48)  # the cut-multigrid hierarchy of the ELL path
MG_TOL, MG_MAXITER, MG_MAX_ITERS = 1e-8, 60, 16
MG_TRUE_TOL = 1e-4    # true f64 relative residual of the f32 MG-CG solution
ELL_DIA_TOL = 1e-5    # ELL vs DIA operator, f32
LMG_NX, LMG_NX_BIG = (12, 24, 48), (16, 32, 64)   # lattice-MG hierarchies
LMG_TOL, LMG_MAXITER, LMG_MAX_ITERS = 1e-8, 100, 12
LMG_TRUE_TOL = {torch.float32: 1e-4, torch.float64: 1e-7}
JACOBI_MAXITER = 3000
F64_SOLVE_TOL = 1e-10   # true relative residual of the native-f64 solves
API_NX = (8, 12, 24, 48)  # examples.fictdom3d levels (EOC over the last 3)
# phase 16: the examples' published settings at the reference tests' sizes,
# then one card size each ("big"), built once through system()
DG_NX, DN_NX, ST_NX, NXF_NX, NXF_LU_NX = (20, 40), 20, (16, 32), 15, 64
# the reference tests' limits at those sizes: DG at nx=40, dn at nx=20,
# nxfem at nx=15, Stokes (u, p) at nx=16 (tests/test_workloads.py:74-83,
# :199-205, tests/test_ghostpenalty.py:13-18, tests/test_stokes.py:11-21)
DG_MAX, DN_MAX, NXF_MAX, ST_MAX = 0.006, 0.08, 0.08, (0.02, 0.05)
# and their convergence under the doubling of nx (DG; Stokes u, p)
DG_RATE, ST_RATE = 3.0, (3.0, 2.5)
BIG_NX = {"fictdom_dg_ghostpen": 256, "fictdom_dn_ghostpen": 256,
          "stokescutfem": 128, "nxfem": 256}
WINDOW = 100  # solver iterations profiled per card-size solve (phase 17)
TOOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12      # H100 SXM, f32 outside the tensor cores
F64_FLOP_PER_S = 34e12      # H100 SXM, f64 outside the tensor cores


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


def lattice_offsets(dim, w):
    """The 3**dim stencil offsets of a lattice with rows of width w."""
    return np.array(sorted({sum(e * w**k for k, e in enumerate(es))
                            for es in itertools.product((-1, 0, 1), repeat=dim)}))


def random_dia(rng, n, offsets, device):
    """Seeded exactly symmetric, diagonally dominant f32 DIA table
    (diagonal 0.01 + the row's absolute off-diagonal sum), a rhs and the
    Jacobi inverse diagonal."""
    offs = [int(o) for o in offsets]
    V = np.zeros((len(offs), n))
    for k, o in enumerate(offs):
        if 0 < o < n:
            d = -rng.uniform(0.0, 1.0, n - o)
            V[k, :n - o] = d
            V[offs.index(-o), o:] = d
    k0 = offs.index(0)
    V[k0] = 0.01 + np.abs(V).sum(0)
    V = torch.as_tensor(V, dtype=torch.float32, device=device)
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                        device=device)
    return V, b, 1.0 / V[k0]


def dia_kernel_vs_plain(label, offs, V, b, dinv, iters_list):
    """Kernel vs plain (rel, residual) and kernel vs kernel (bitwise) for
    each iteration count.  Returns [(label, iters, rel, max|x_k - x_p|)]."""
    from ngsxfem_tpu_torch.solvers import dia_cg

    bn = float(torch.linalg.vector_norm(b))
    out = []
    for iters in iters_list:
        xk, rk = dia_cg.dia_cg_fused(offs, V, b, dinv, iters)
        xk2, rk2 = dia_cg.dia_cg_fused(offs, V, b, dinv, iters)
        xp, rp = dia_cg.dia_cg_fused_plain(offs, V, b, dinv, iters)
        torch.cuda.synchronize()
        rel = float(torch.linalg.vector_norm(xk - xp)
                    / torch.linalg.vector_norm(xp).clamp_min(1e-30))
        check(rel <= KERNEL_TOL, f"{label} iters={iters}: rel {rel}")
        check(abs(float(rk) - float(rp)) <= KERNEL_TOL * bn,
              f"{label} iters={iters}: res {float(rk)} vs {float(rp)}")
        check(torch.equal(xk, xk2) and torch.equal(rk, rk2),
              f"{label} iters={iters}: two kernel runs differ")
        out.append((label, iters, rel, float((xk - xp).abs().max())))
    return out


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


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def per_call_ms(fn, calls):
    """Mean CUDA-event time of one call of `fn` in ms, over `calls` calls
    back to back, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_kernels(fn, calls, warm=True):
    """torch.profiler over `calls` calls of `fn` after a warm-up (left out
    with warm=False, for a caller that has just run `fn`): ({kernel name:
    (launches, device us)}, host wall ms of the window)."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", getattr(evt, "cuda_time_total", 0))
        if us and evt.count:
            out[evt.key] = (evt.count, us)
    return out, wall_ms


def bound(nbytes, flops, flop_per_s=F32_FLOP_PER_S):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over HBM bandwidth and the operations over the
    peak rate of their type (f32 unless given; H100 SXM data sheet)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / flop_per_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def dia_cg_bound(offsets, n, iters):
    """B1: inputs read once (the main and upper diagonals the kernel reads,
    b, dinv), x written once; per iteration 2 flops per offset per row for
    the SpMV plus 11 per row for the dots and updates."""
    rows = sum(1 for o in np.asarray(offsets).tolist() if o >= 0)
    return bound((rows * n + 2 * n) * 4 + n * 4,
                 iters * (2 * len(offsets) + 11) * n + 5 * n)


def ell_bound(n, K, ncols, itemsize):
    """B2 on the padded table: vals and int32 cols (n, K) and x read once,
    y written once; 2 flops per slot."""
    return nnz_bound(n * K, n, ncols, itemsize)


def nnz_bound(nnz, n, ncols, itemsize):
    """B2 whatever layout implements it: each of the table's ``nnz`` real
    slots (value and int32 column) and x read once, y written once; 2 flops
    per slot."""
    return bound(nnz * (4 + itemsize) + ncols * itemsize + n * itemsize,
                 2 * nnz, F64_FLOP_PER_S if itemsize == 8 else F32_FLOP_PER_S)


def ell_level(nx, device, model=None):
    """One level of the ELL path: model (reused when given), ELL structure,
    f32 table, ncut, interface-dof mask (dofs of cut elements, active)."""
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson

    if model is None:
        model = UnfittedPoisson(nx=nx, dim=3, order=1, dtype=torch.float32,
                                device=device)
    struct = model.ell_structure()
    V, ncut = model.assemble_vals_soa1(model.vertices, model.lset, struct)
    ve = model.lset_np[model.mesh.elements_np]
    cut = (ve < 0).any(1) & (ve > 0).any(1)
    ifm = np.zeros(model.ndof, bool)
    ifm[model.space.el2dof_np[cut].ravel()] = True
    return {"nx": nx, "model": model, "struct": struct, "V": V, "ncut": ncut,
            "if_mask": ifm & model.active_dofs}


def random_ell(rng, n, K, ncols, dtype, device, nan=False):
    """Seeded ELL table with trailing padding (col 0, val 0) of a random
    length in each row (so row lengths vary inside each slice of 32), the
    first rows all padding, and an x; ``nan`` poisons the whole table as
    ``_band_guard`` does."""
    cols = rng.integers(0, ncols, size=(n, K)).astype(np.int32)
    vals = rng.standard_normal((n, K))
    pad = np.arange(K)[None, :] >= rng.integers(0, K + 1, size=(n, 1))
    pad[:40] = True
    cols[pad] = 0
    vals[pad] = 0.0
    if nan:
        vals = vals * np.nan
    x = rng.standard_normal(ncols)
    return (torch.as_tensor(vals, dtype=dtype, device=device),
            torch.as_tensor(cols, device=device),
            torch.as_tensor(x, dtype=dtype, device=device))


def _same(a, b, bits):
    """a == b: bit for bit (``bits``) or under ``torch.equal``, NaN at the
    same places counting as equal."""
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    if bits:
        it = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
        return torch.equal(a[~na].view(it), b[~nb].view(it))
    return torch.equal(a[~na], b[~nb])


def ell_kernel_vs_plain(cases):
    """Each (label, vals, cols, x): on the table's layout, kernel ==
    ``sell_matvec_plain`` bit for bit, kernel == ``ell_matvec_plain`` under
    ``torch.equal``, two kernel runs bit for bit.  The layouts and launches
    made here are not any path's: both counters are put back.  Returns
    (the largest |y_kernel - y_plain|, the last case's layout)."""
    from ngsxfem_tpu_torch.solvers import ell_spmv

    counts = ell_spmv.launches, ell_spmv.layouts_built
    worst, L = 0.0, None
    for label, vals, cols, x in cases:
        L = ell_spmv.prepare_ell(vals, cols, x.shape[0])
        yk = ell_spmv.ell_matvec(vals, cols, x, L)
        yk2 = ell_spmv.ell_matvec(vals, cols, x, L)
        ys = ell_spmv.sell_matvec_plain(L, x)
        yp = ell_spmv.ell_matvec_plain(vals, cols, x)
        torch.cuda.synchronize()
        fin = torch.isfinite(yk) & torch.isfinite(yp)
        err = float((yk - yp)[fin].abs().max()) if fin.any() else 0.0
        check(_same(yk, yk2, True), f"{label}: two kernel runs differ")
        check(_same(yk, ys, True),
              f"{label}: kernel != sell_matvec_plain bit for bit")
        check(_same(yk, yp, False),
              f"{label}: kernel != ell_matvec_plain, max|dy| {err}")
        worst = max(worst, err)
    ell_spmv.launches, ell_spmv.layouts_built = counts
    return worst, L


def slice_stats(L):
    """'slice_K min/median/max, fill' of a layout, for the logs."""
    sk = L.slice_K.cpu().numpy()
    med = float(np.median(sk)) if sk.size else 0.0
    return (f"slice_K min/median/max {sk.min() if sk.size else 0}/{med:g}/"
            f"{L.kmax}, {L.nnz} real slots of {L.vals.shape[0]} stored, "
            f"slice fill {L.fill:.4f}")


def dia_as_ell(dia, perm, perm_inv):
    """The DIA table ``dia["V"]`` (vertex numbering) as an ELLMatrix in dof
    numbering: row d holds the n_off diagonals of vertex row perm[d] in
    offset order, out-of-range slots padded (col 0, val 0).  Its row sums
    run in ``dia_matvec``'s order, so it is the same f32 operator."""
    from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix

    V = dia["V"]
    n = V.shape[1]
    offs = torch.as_tensor(np.asarray(dia["offsets"]), device=V.device)
    c = perm[:, None] + offs[None, :]
    ok = (c >= 0) & (c < n)
    cols = torch.where(ok, perm_inv[c.clamp(0, n - 1)], 0).to(torch.int32)
    vals = torch.where(ok, V[:, perm].T, 0.0).contiguous()
    return ELLMatrix(cols.contiguous(), vals, (n, n))


def ell_path(device, model48, dia, x_dia):
    """The ELL path: levels MG_NX (the finest reuses the DIA path's model),
    operator and Jacobi-CG-50 checks against the DIA path, FunctionalELLMG
    with prepare_host, MG-CG to MG_TOL.  Returns what phase 8 times."""
    from ngsxfem_tpu_torch.solvers import ell_spmv
    from ngsxfem_tpu_torch.solvers import mg as mgmod
    from ngsxfem_tpu_torch.solvers.krylov import CGSolver, cg
    from ngsxfem_tpu_torch.solvers.ell_spmv import ell_matvec
    from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix, dia_matvec

    t0 = time.perf_counter()
    levels = [ell_level(nx, device, model48 if nx == model48.nx else None)
              for nx in MG_NX]
    levels_s = time.perf_counter() - t0
    fine = levels[-1]
    m = fine["model"]
    cols = torch.as_tensor(fine["struct"]["ell_cols"], device=device)
    A = ELLMatrix(cols, fine["V"], (m.ndof, m.ndof))

    # the ELL operator equals the DIA operator after the renumbering
    perm = torch.as_tensor(dia["perm"], device=device)
    perm_inv = torch.as_tensor(dia["perm_inv"], device=device)
    xr = torch.as_tensor(np.random.default_rng(11).standard_normal(m.ndof),
                         dtype=torch.float32, device=device)
    y_dia = dia_matvec(dia["offsets"], dia["V"], xr[perm_inv])[perm]
    rel_op = float(torch.linalg.vector_norm(A @ xr - y_dia)
                   / torch.linalg.vector_norm(y_dia))

    # Jacobi-CG-50 through CGSolver (the ELL kernel) against the DIA-PCG
    # kernel's x: on the ELL form of the DIA table, the same f32 operator,
    # and on the assembled ELL table, an operator that differs from it in
    # the last bits (f32 CG-50 on this system amplifies such differences)
    b = torch.as_tensor(np.where(m.active_dofs, 1.0, 0.0), dtype=torch.float32,
                        device=device)
    xd = x_dia[perm]
    A_dia = dia_as_ell(dia, perm, perm_inv)
    rel_dia_ell = float(torch.linalg.vector_norm(A_dia @ xr - y_dia)
                        / torch.linalg.vector_norm(y_dia))
    x50 = CGSolver(A_dia, maxsteps=CG_ITERS, tol=0.0) * b
    rel_cg = float(torch.linalg.vector_norm(x50 - xd)
                   / torch.linalg.vector_norm(xd))
    x50_asm = CGSolver(A, maxsteps=CG_ITERS, tol=0.0) * b
    rel_cg_asm = float(torch.linalg.vector_norm(x50_asm - xd)
                       / torch.linalg.vector_norm(xd))
    # true f64 relative residuals, on the assembled ELL table, of the two
    # f32 trajectories' x
    b64, A64 = b.double(), A.vals.double()
    res50 = [float(torch.linalg.vector_norm(
        b64 - ell_matvec(A64, A.cols, v.double()))
        / torch.linalg.vector_norm(b64)) for v in (xd, x50_asm)]

    # cut multigrid as the CG preconditioner
    t0 = time.perf_counter()
    prols = [mgmod.prolongation_coo_np(levels[i]["model"].space,
                                       levels[i + 1]["model"].space)
             for i in range(len(levels) - 1)]
    mg = mgmod.FunctionalELLMG(
        [lv["struct"]["ell_cols"] for lv in levels], prols,
        if_masks=[None] + [lv["if_mask"] for lv in levels[1:]], if_iters=10,
        active_masks=[lv["model"].active_dofs for lv in levels])
    mg_setup_s = time.perf_counter() - t0
    params = mg.params([lv["V"] for lv in levels], dtype=torch.float32,
                       device=device)
    layouts_before = ell_spmv.layouts_built
    t0 = time.perf_counter()
    pp = mg.prepare_host(params)
    sync(device)
    prepare_s = time.perf_counter() - t0
    # the solve's tables: the level operators (the finest is the CG's
    # operator too), the transfers and the interface blocks
    ntables = (len(pp["ops"]) + len(pp["R_ops"]) + len(pp["P_ops"])
               + sum(s is not None for s in pp["if_ops"]))

    def mgcg(pp=pp):
        return cg(pp["ops"][-1].matvec, b, M=lambda r: mg.apply(pp, r),
                  maxiter=MG_MAXITER, tol=MG_TOL)

    t0 = time.perf_counter()
    x, iters, res = mgcg()
    sync(device)
    mgcg_wall_s = time.perf_counter() - t0
    layouts = ell_spmv.layouts_built - layouts_before
    want = ntables if ell_spmv.uses_layout(b) else 0  # none on the CPU
    check(layouts == want, f"MG-CG: {layouts} layouts built for "
                           f"{ntables} tables, {want} expected")
    return {"levels": levels, "A": A, "xr": xr, "b": b, "x": x,
            "iters": iters, "res": res, "rel_op": rel_op, "rel_cg": rel_cg,
            "rel_dia_ell": rel_dia_ell, "rel_cg_asm": rel_cg_asm,
            "res50": res50, "layouts": layouts, "params": params,
            "mg": mg, "pp": pp, "mgcg": mgcg, "levels_s": levels_s,
            "mg_setup_s": mg_setup_s, "prepare_s": prepare_s,
            "mgcg_wall_s": mgcg_wall_s}


def repeat_assembly(ell, reps=5):
    """The finest level's table assembled ``reps`` more times as a user's
    call assembles it (no global flag): each bitwise equal to the first,
    and MG-CG on each (``prepare_host`` anew) in the same number of
    iterations.  Returns the iteration counts."""
    fine = ell["levels"][-1]
    m, mg, params = fine["model"], ell["mg"], ell["params"]
    iters = []
    for _ in range(reps):
        V, _ = m.assemble_vals_soa1(m.vertices, m.lset, fine["struct"])
        check(_same(V.reshape(-1), fine["V"].reshape(-1), True),
              f"assemble_vals_soa1 nx={fine['nx']}: the table changed "
              f"between two assemblies")
        pp = mg.prepare_host(dict(params, vals=params["vals"][:-1] + [V]))
        iters.append(int(ell["mgcg"](pp)[1]))
    check(iters == [ell["iters"]] * reps,
          f"MG-CG iterations over {reps} assemblies {iters}, first "
          f"{ell['iters']}")
    return iters


# --- phases 9-11: general cut quadrature and the quadrature path ----------

EXACT_TOL = 5e-15      # x (order + 1)^2, the reference suite's bound
SPHERE_R = 0.4
SPHERE_NX = {"tet": (16, 32, 64), "hex": (12, 24, 48)}
EOC_MIN = 1.75
ORDER2_NX = 24
QUAD_OP_TOL = {torch.float64: 1e-11, torch.float32: 1e-5}


def _mesh(T, et, n):
    if et == "segm":
        return T.Make1DMesh(n)
    if et in ("trig", "quad"):
        return T.MakeStructured2DMesh(quads=et == "quad", nx=n, ny=n)
    return T.MakeStructured3DMesh(hexes=et == "hex", nx=n, ny=n, nz=n)


def _p1(T, mesh, lset_cf, device, dtype=torch.float64):
    gf = T.GridFunction(T.H1(mesh, order=1, device=device), dtype=dtype)
    T.InterpolateToP1(lset_cf, gf)
    return gf


def cut_exactness(device):
    """The reference suite's exactness cases (tests/test_straightcutrule.py:
    17-137, tests/test_quadchallenges.py) on the card, f64.  Returns (cases,
    worst error / bound) and raises past the bound."""
    import ngsxfem_tpu_torch as T

    x, y, z = T.x, T.y, T.z
    worst, n = 0.0, 0

    def case(et, N, lset_cf, f, order, dt, ref, policy=None, tol=None):
        nonlocal worst, n
        mesh = _mesh(T, et, N)
        ld = {"levelset": _p1(T, mesh, lset_cf, device),
              "domain_type": getattr(T, dt)}
        if policy:
            ld["quad_dir_policy"] = policy
        got = T.Integrate(ld, f, mesh, order=order)
        bound = tol if tol is not None else EXACT_TOL * (order + 1) ** 2
        check(abs(got - ref) <= bound,
              f"exactness {et} N={N} order={order} {dt}: {got} vs {ref}")
        worst = max(worst, abs(got - ref) / bound)
        n += 1
        return got

    xa = 0.78522
    for alpha in (2, 4, 8):
        for dt, ref in (("POS", xa ** (alpha + 1) / (alpha + 1)),
                        ("NEG", (1 - xa ** (alpha + 1)) / (alpha + 1)),
                        ("IF", xa ** alpha)):
            case("segm", 1, xa - x, x ** alpha, alpha, dt, ref)
    for et in ("trig", "quad"):
        for N in (1, 10):
            for order in (2, 4, 8):
                for dt, ref in (("NEG", 7 / 8), ("POS", 1 / 8),
                                ("IF", 1 / np.sqrt(2))):
                    case(et, N, 1 - 2 * x - 2 * y, T.CoefficientFunction(1),
                         order, dt, ref)
        for order in (2, 4, 8):
            for alpha in (0, 1, 2):
                vp = 2 ** (-alpha - 2) / (alpha * alpha + 3 * alpha + 2)
                for c in (x, y):
                    for dt, ref in (("POS", vp), ("NEG", 1 / (alpha + 1) - vp)):
                        case(et, 1, 1 - 2 * x - 2 * y, c ** alpha, order, dt,
                             ref)
        for eps in (1e-1, 1e-2, 5e-3, 1e-3, 0):
            for lcf in (1 - 2 * x + eps * (y - 0.5), 1 - 2 * y + eps * (x - 0.5)):
                for dt, ref in (("NEG", 0.5), ("POS", 0.5),
                                ("IF", np.sqrt(1 + eps * eps / 4))):
                    case(et, 1, lcf, T.CoefficientFunction(1), 2, dt, ref)
    plane3 = 1 - 2 * x - 2 * y - 2 * z
    for et in ("tet", "hex"):
        for order in (2, 4, 8):
            for dt, ref in (("POS", 1 / 48), ("NEG", 47 / 48),
                            ("IF", np.sqrt(3) / 8)):
                case(et, 1, plane3, T.CoefficientFunction(1), order, dt, ref)
                if et == "hex":
                    case(et, 2, plane3, 1.0, order, dt, ref)
        for alpha in (0, 1, 2):
            vp = 2 ** (-alpha - 3) / (alpha ** 3 + 6 * alpha ** 2 + 11 * alpha + 6)
            for c in (x, y, z):
                for dt, ref in (("POS", vp), ("NEG", 1 / (alpha + 1) - vp)):
                    case(et, 1, plane3, c ** alpha, 4, dt, ref)
                    if et == "hex":
                        case(et, 5, plane3, c ** alpha, 4, dt, ref,
                             policy="OPTIMAL")
    vp = 2 ** (-5) / (8 + 24 + 22 + 6)
    case("hex", 2, plane3, x ** 2, 4, "POS", vp, policy="OPTIMAL")
    # the trilinear TPMC level set (tests/test_quadchallenges.py:77-135)
    tpmc = x * ((7 * y - 13) * z + 6) + y * (3 - 8 * z) + 8 * z - 4
    for order in (2, 4, 6):
        neg = case("hex", 1, tpmc, 1.0, order, "NEG", 0.5167820912197415,
                   tol=0.75)
        pos = case("hex", 1, tpmc, 1.0, order, "POS", 0.4825797907263282,
                   tol=0.75)
        check(abs(neg + pos - 1.0) <= 1e-12, f"TPMC order {order}: NEG+POS")
    for order in (2, 4):
        for dt, ref, tol in (("NEG", 0.51681, 1e-3), ("POS", 0.48319, 1e-3),
                             ("IF", 1.82169, 5e-3)):
            case("hex", 10, tpmc, 1.0, order, dt, ref, tol=tol)
    # the plane on 256 x 256 meshes (131,072 triangles, 65,536 quads)
    for et in ("trig", "quad"):
        for dt, ref in (("NEG", 7 / 8), ("POS", 1 / 8), ("IF", 1 / np.sqrt(2))):
            case(et, 256, 1 - 2 * x - 2 * y, 1.0, 4, dt, ref, tol=1e-12)
    return n, worst


def sphere_levels(device):
    """Order-4 NEG volume and IF area of the ball r=0.4 at the centre of the
    unit cube on tets and hexes (SPHERE_NX): errors, EOC, NEG + POS, and
    element_wise sums.  Returns the rows and the finest tet mesh with its
    level set (reused by the CutInfo check and phase 11)."""
    import ngsxfem_tpu_torch as T

    c = T.sqrt((T.x - 0.5) ** 2 + (T.y - 0.5) ** 2 + (T.z - 0.5) ** 2) - SPHERE_R
    exact = {"NEG": 4 / 3 * np.pi * SPHERE_R ** 3, "IF": 4 * np.pi * SPHERE_R ** 2}
    rows = []
    for et, nxs in SPHERE_NX.items():
        err = {"NEG": [], "IF": []}
        for nx in nxs:
            mesh = _mesh(T, et, nx)
            lset = _p1(T, mesh, c, device)
            if et == "tet":
                finest = (mesh, lset)
            got = {}
            for dt in ("NEG", "POS", "IF"):
                ld = {"levelset": lset, "domain_type": getattr(T, dt)}
                got[dt] = T.Integrate(ld, 1.0, mesh, order=4)
                ew = T.Integrate(ld, 1.0, mesh, order=4, element_wise=True)
                check(abs(float(ew.sum()) - got[dt]) <= 1e-12 * got[dt],
                      f"{et} nx={nx} {dt}: element_wise sum")
            check(abs(got["NEG"] + got["POS"] - 1.0) <= 1e-12,
                  f"{et} nx={nx}: NEG + POS = {got['NEG'] + got['POS']}")
            for dt in err:
                err[dt].append(abs(got[dt] - exact[dt]))
        eoc = {dt: float(np.log(e[-2] / e[-1]) / np.log(2)) for dt, e in err.items()}
        for dt in eoc:
            check(eoc[dt] >= EOC_MIN, f"{et} {dt}: EOC {eoc[dt]} < {EOC_MIN}")
        rows.append((et, nxs, err, eoc, peak_gib(device)))
    return rows, finest


def autograd_check(device):
    """dV/dr of the ball through the cut rule by torch.autograd at tets
    nx=32, r=0.31 (tests/test_misc.py:331-343): near 4 pi r^2, and equal to
    the central difference (f64, eps 1e-5).  Returns (grad, fd)."""
    from ngsxfem_tpu_torch.mesh.mesh import map_points, det_and_inv
    from ngsxfem_tpu_torch.mesh.structured import MakeStructured3DMesh
    from ngsxfem_tpu_torch.ops.straightcut import cut_rule_element

    m = MakeStructured3DMesh(hexes=False, nx=32, ny=32, nz=32)
    dist = torch.as_tensor(np.sqrt(((m.vertices_np - 0.5) ** 2).sum(1))[m.elements_np],
                           device=device)
    coords = torch.as_tensor(m.vertices_np[m.elements_np], device=device)

    def vol(r):
        rule = cut_rule_element("tet", dist - r, 2)
        _, J = map_points("tet", coords, rule.pts)
        return (rule.w * (rule.side == 0) * det_and_inv(J)[0].abs()).sum()

    r = torch.tensor(0.31, dtype=torch.float64, device=device, requires_grad=True)
    vol(r).backward()
    g = float(r.grad)
    with torch.no_grad():
        fd = float((vol(torch.tensor(0.31 + 1e-5, dtype=torch.float64, device=device))
                    - vol(torch.tensor(0.31 - 1e-5, dtype=torch.float64,
                                       device=device))) / 2e-5)
    check(abs(g - 4 * np.pi * 0.31 ** 2) < 0.03, f"dV/dr {g} vs 4 pi r^2")
    check(abs(g - fd) <= 1e-6 * abs(fd), f"dV/dr {g} vs central difference {fd}")
    return g, fd


def cutinfo_check(mesh, lset):
    """CutInfo at the finest tet level: element counts equal a numpy sign
    count of the eps-guarded vertex values, ratios in [0, 1], and the
    facets with neighbours (HASNEG, IF) are non-empty and lie between such
    elements.  Returns (NEG, POS, IF counts, marked facets)."""
    import ngsxfem_tpu_torch as T
    from ngsxfem_tpu_torch.integrate import vertex_local_ids

    ci = T.CutInfo(mesh, lset)
    v = lset.vec.NumPy()[lset.space.el2dof_np[:, vertex_local_ids(mesh.et, 1)]]
    v = np.where(np.abs(v) < 1e-14, 1e-14, v)
    neg, pos = (v < 0).any(1), (v > 0).any(1)
    counts = tuple(ci.GetElementsOfType(getattr(T, dt)).NumSet()
                   for dt in ("NEG", "POS", "IF"))
    host = (int((neg & ~pos).sum()), int((pos & ~neg).sum()), int((neg & pos).sum()))
    check(counts == host, f"CutInfo counts {counts} != host {host}")
    r = ci.GetCutRatios()
    check(bool(((r >= 0) & (r <= 1)).all()), "cut ratios outside [0, 1]")
    hn, hi = ci.GetElementsOfType(T.HASNEG), ci.GetElementsOfType(T.IF)
    f = T.GetFacetsWithNeighborTypes(mesh, a=hn, b=hi)
    check(f.NumSet() > 0, "no facets with neighbours (HASNEG, IF)")
    f2e = mesh.facet2el_np[f.np]
    check(bool(((f2e >= 0).all(1) & hn.np[f2e].all(1) & hi.np[f2e].any(1)).all()),
          "a marked facet is not between HASNEG and IF elements")
    return counts, f.NumSet()


def quad_flagship(device, model, struct, V32):
    """Phase 10: the quadrature path of the flagship at nx=48 against the
    lattice DIA operator, its rhs against Integrate, solve() in f32, and the
    order-2 symmetry probe at nx=24.  Returns what phase 10 prints."""
    import ngsxfem_tpu_torch as T
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
    from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

    out = {}
    offs = struct["offsets"]
    perm = torch.as_tensor(struct["perm"], device=device)
    perm_inv = torch.as_tensor(struct["perm_inv"], device=device)
    v64 = torch.as_tensor(model.mesh.vertices_np, dtype=torch.float64, device=device)
    l64 = torch.as_tensor(model.lset_np, dtype=torch.float64, device=device)
    V64, _ = model.assemble_vals_lattice(v64, l64, struct)
    xr = np.random.default_rng(12).standard_normal(model.ndof)
    for dt, (v, l, V) in ((torch.float64, (v64, l64, V64)),
                          (torch.float32, (model.vertices, model.lset, V32))):
        x = torch.as_tensor(xr, dtype=dt, device=device)
        y = model.apply(v, l, x)
        yd = dia_matvec(offs, V, x[perm_inv])[perm]
        rel = float(torch.linalg.vector_norm(y - yd) / torch.linalg.vector_norm(yd))
        check(rel <= QUAD_OP_TOL[dt], f"quadrature vs DIA operator {dt}: rel {rel}")
        out[f"op_{str(dt)[6:]}"] = rel

    # rhs: sum and a random projection against Integrate over NEG
    one = lambda p: torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    b = model.rhs(v64, l64, one)
    mesh = model.mesh
    lset = T.GridFunction(T.H1(mesh, order=1, device=device))
    lset.vec.data = l64[torch.as_tensor(model.p1dof2vertex, device=device)]
    ld = {"levelset": lset, "domain_type": T.NEG}
    vol = T.Integrate(ld, 1.0, mesh, order=5)
    u = T.GridFunction(T.H1(mesh, order=1, device=device))
    u.vec.data = torch.as_tensor(xr, device=device)
    proj = T.Integrate(ld, u, mesh, order=5)
    out["rhs_sum"] = (float(b.sum()), vol)
    out["rhs_proj"] = (float(b @ u.vec.data), proj)
    check(abs(float(b.sum()) - vol) <= 1e-12 * vol, f"sum(rhs) {float(b.sum())} vs {vol}")
    check(abs(float(b @ u.vec.data) - proj) <= 1e-12 * abs(b).sum().item(),
          f"x.rhs {float(b @ u.vec.data)} vs Integrate(NEG, u_x) {proj}")

    # solve() in f32 with its defaults; its recursion residual against the
    # true residual of x in f64 on the f64 operator
    t0 = time.perf_counter()
    x, k, res = model.solve()
    sync(device)
    out["solve_s"] = time.perf_counter() - t0
    check(bool(torch.isfinite(x).all()), "solve(): non-finite x")
    b32 = model.rhs(model.vertices, model.lset, one)
    true64 = float(torch.linalg.vector_norm(
        b32.double() - model.apply(v64, l64, x.double())))
    out["solve"] = (k, float(res), true64, float(torch.linalg.vector_norm(b32)))
    check(abs(float(res) - true64) <= 1e-2 * true64,
          f"solve(): recursion residual {float(res)} vs true f64 {true64}")

    # order 2: symmetry of the f32 operator (bench.py:651-656), the dots
    # accumulated in f64 as krylov._vdot does (an f32 dot alone gives ~5e-7)
    m2 = UnfittedPoisson(nx=ORDER2_NX, dim=3, order=2, dtype=torch.float32,
                         device=device)
    op = m2.operator(m2.vertices, m2.lset)
    uu = torch.cos(torch.arange(m2.ndof, dtype=torch.float32, device=device))
    vv = torch.sin(torch.arange(m2.ndof, dtype=torch.float32, device=device))
    dot = lambda a, b: float(torch.dot(a.double(), b.double()))
    uav, vau = dot(uu, op(vv)), dot(vv, op(uu))
    sym = abs(uav - vau) / max(abs(uav), 1e-30)
    check(sym <= 1e-6, f"order-2 symmetry probe {sym}")
    out["sym2"] = (m2.ndof, sym)
    return out


def lattice_level(model, struct, V):
    """One level of the lattice multigrid, as bench.py builds it: offsets,
    DIA table, active mask and interface mask (dofs of cut elements, active)
    in vertex-lex order."""
    from ngsxfem_tpu_torch.config import config

    eps = config.lset_eps
    ge = model.lset_np[model.mesh.elements_np]
    ge = np.where(np.abs(ge) < eps, np.where(ge >= 0, eps, -eps), ge)
    cut = (ge < 0).any(1) & (ge > 0).any(1)
    ifd = np.zeros(model.ndof, bool)
    ifd[model.space.el2dof_np[cut].ravel()] = True
    pinv = struct["perm_inv"]
    return {"nx": model.nx, "model": model, "struct": struct, "V": V,
            "offsets": struct["offsets"], "act": model.active_dofs[pinv],
            "if_mask": (ifd & model.active_dofs)[pinv]}


def new_lattice_level(nx, device, dtype):
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson

    model = UnfittedPoisson(nx=nx, dim=3, order=1, dtype=dtype, device=device)
    struct = model.dia_structure()
    V, _ = model.assemble_vals_lattice(model.vertices, model.lset, struct)
    return lattice_level(model, struct, V)


def lattice_mg(levels, dtype, device, jacobi=True):
    """LatticeDIAMG on `levels` (coarse to fine) as the preconditioner of
    krylov.cg to LMG_TOL, beside Jacobi-CG to the same tolerance.  Checks
    the coarse inverse, the residuals and the iteration limits; returns the
    numbers and the closures that phase 15 times."""
    from ngsxfem_tpu_torch.solvers.krylov import cg
    from ngsxfem_tpu_torch.solvers.latticemg import LatticeDIAMG
    from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

    nxs = [lv["nx"] for lv in levels]
    mg = LatticeDIAMG([lv["offsets"] for lv in levels], [n + 1 for n in nxs],
                      dim=3, active_masks=[lv["act"] for lv in levels],
                      if_masks=[None] + [lv["if_mask"] for lv in levels[1:]])
    params = mg.params([lv["V"] for lv in levels], dtype=dtype, device=device)
    t0 = time.perf_counter()
    pp = mg.prepare_safe(params)   # raises on a bad coarse inverse
    sync(device)
    prepare_s = time.perf_counter() - t0
    label = f"lattice MG nx={nxs} {dtype}"
    ainv_res = float(pp["ainv0_res"])
    check(ainv_res <= 1e-3, f"{label}: coarse inverse residual {ainv_res}")
    offs = levels[-1]["offsets"]
    Vf = pp["vals"][-1]
    b = torch.as_tensor(np.where(levels[-1]["act"], 1.0, 0.0), dtype=dtype,
                        device=device)
    bn = float(torch.linalg.vector_norm(b))
    mv = lambda z: dia_matvec(offs, Vf, z)
    mgcg = lambda: cg(mv, b, M=lambda r: mg.apply(pp, r),
                      maxiter=LMG_MAXITER, tol=LMG_TOL)
    x, k, res = mgcg()
    check(float(res) <= 1.5 * LMG_TOL * bn,
          f"{label}: MG-CG res {float(res)} > {1.5 * LMG_TOL * bn}")
    check(k <= LMG_MAX_ITERS, f"{label}: MG-CG took {k} iterations")
    r64 = b.double() - dia_matvec(offs, Vf.double(), x.double())
    true_rel = float(torch.linalg.vector_norm(r64)) / bn
    check(true_rel <= LMG_TRUE_TOL[dtype],
          f"{label}: MG-CG true f64 rel res {true_rel}")
    out = {"nxs": nxs, "dtype": dtype, "mg": mg, "params": params, "pp": pp,
           "prepare_s": prepare_s, "ainv_res": ainv_res, "iters": k,
           "rel": float(res) / bn, "true_rel": true_rel, "mgcg": mgcg,
           "x": x, "n0": int(pp["ainv0"].shape[0])}
    if jacobi:
        k0 = int(np.searchsorted(offs, 0))
        dinv = torch.where(Vf[k0].abs() > 1e-30, 1.0 / Vf[k0], 1.0)
        jcg = lambda: cg(mv, b, M=lambda r: dinv * r, maxiter=JACOBI_MAXITER,
                         tol=LMG_TOL)
        _, kj, rj = jcg()
        check(k < kj / 2, f"{label}: MG-CG {k} iterations, Jacobi-CG {kj}")
        out.update(jacobi_iters=kj, jacobi_rel=float(rj) / bn, jcg=jcg)
    return out


def native_f64(device, V32, b32):
    """Phase 13: the flagship in native f64 at nx=48.  Returns the model,
    its table and what phase 15 times."""
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
    from ngsxfem_tpu_torch.solvers.krylov import cg, cg_ir
    from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

    model = UnfittedPoisson(nx=NX, dim=3, order=1, dtype=torch.float64,
                            device=device)
    struct = model.dia_structure()
    V, ncut = model.assemble_vals_lattice(model.vertices, model.lset, struct)
    offs = struct["offsets"]
    check(V.dtype == torch.float64, f"f64 table has dtype {V.dtype}")
    dv = float((V - V32.to(V.device).double()).abs().max() / V.abs().max())
    check(dv <= 2e-5, f"f64 vs f32 lattice table: {dv} of max|V|")
    check(is_symmetric(V, offs), "f64 DIA table is not exactly symmetric")
    k0 = int(np.searchsorted(offs, 0))
    b = b32.double()
    bn = float(torch.linalg.vector_norm(b))
    dinv = torch.where(V[k0].abs() > 1e-30, 1.0 / V[k0], 1.0)
    mv64 = lambda v: dia_matvec(offs, V, v)
    V32b = V.float()
    dinv32 = dinv.float()
    mv32 = lambda v: dia_matvec(offs, V32b, v)
    pcg = lambda: cg(mv64, b, M=lambda r: dinv * r, maxiter=JACOBI_MAXITER,
                     tol=1e-12)
    ir = lambda: cg_ir(mv32, mv64, b, M=lambda r: dinv32 * r, outer=IR_OUTER,
                       inner=IR_INNER)
    x, k, _ = pcg()
    pcg_rel = float(torch.linalg.vector_norm(b - mv64(x))) / bn
    check(pcg_rel <= F64_SOLVE_TOL, f"f64 PCG true rel res {pcg_rel}")
    x_ir, res_ir = ir()
    ir_rel = float(res_ir) / bn
    check(ir_rel <= F64_SOLVE_TOL, f"cg_ir true rel res {ir_rel}")
    dx = float(torch.linalg.vector_norm(x - x_ir) / torch.linalg.vector_norm(x))
    check(dx <= 1e-8, f"f64 PCG vs cg_ir solutions: rel {dx}")
    return {"model": model, "struct": struct, "V": V, "ncut": int(ncut),
            "dv": dv, "pcg_iters": k, "pcg_rel": pcg_rel, "ir_rel": ir_rel,
            "dx": dx, "pcg": pcg, "ir": ir}


def fictdom3d_forms(T, mesh, lset_values, lam, gamma, device):
    """The flagship's three integrators and its load written as weak forms
    on `mesh` with the P1 level set `lset_values` (one per vertex), as
    examples/fictdom3d.py writes them.  Returns (a, f, free dofs), not yet
    assembled."""
    P1 = T.H1(mesh, order=1, device=device)
    lsetp1 = T.GridFunction(P1)
    from ngsxfem_tpu_torch.integrate import _p1_vertex_dofs

    vec = np.zeros(P1.ndof)
    vec[_p1_vertex_dofs(P1)] = lset_values
    lsetp1.vec.data = vec
    ci = T.CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(T.HASNEG)
    hasif = ci.GetElementsOfType(T.IF)
    Vh = T.H1(mesh, order=1, dgjumps=True, device=device)
    u, v = Vh.TnT()
    h = T.specialcf.mesh_size
    n = 1.0 / T.Norm(T.grad(lsetp1)) * T.grad(lsetp1)
    neg = {"levelset": lsetp1, "domain_type": T.NEG}
    iff = {"levelset": lsetp1, "domain_type": T.IF}
    a = T.BilinearForm(Vh)
    a += T.SymbolicBFI(neg, form=T.grad(u) * T.grad(v),
                       definedonelements=hasneg)
    a += T.SymbolicBFI(iff, form=-(T.grad(u) * n) * v - (T.grad(v) * n) * u
                       + lam / h * u * v)
    a += T.SymbolicFacetPatchBFI(
        form=gamma / (h * h) * (u - u.Other()) * (v - v.Other()),
        definedonelements=T.GetFacetsWithNeighborTypes(mesh, a=hasneg,
                                                       b=hasif))
    f = T.LinearForm(Vh)
    f += T.SymbolicLFI(neg, form=T.CoefficientFunction(6.0) * v,
                       definedonelements=hasneg)
    return a, f, T.GetDofsOfElements(Vh, hasneg)


def forms_vs_model(T, model, struct, V, device):
    """The weak-form operator on the hand-written model's own mesh and level
    set against the model's DIA operator, on active dofs, over three seeded
    vectors (f64).  Returns (worst rel, the assembled form)."""
    from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

    a, _, _ = fictdom3d_forms(T, model.mesh, model.lset_np, model.lam_nitsche,
                              model.gamma_gp, device)
    a.Assemble()
    act = model.active_dofs
    perm, pinv = struct["perm"], struct["perm_inv"]
    rng = np.random.default_rng(2028)
    worst = 0.0
    for _ in range(3):
        xv = np.where(act, rng.standard_normal(model.ndof), 0.0)
        y_forms = (a.mat * torch.as_tensor(xv, device=device)).cpu().numpy()
        y_dia = dia_matvec(struct["offsets"], V, torch.as_tensor(
            xv[pinv], dtype=V.dtype, device=V.device)).cpu().numpy()[perm]
        worst = max(worst, float(np.linalg.norm((y_forms - y_dia)[act])
                                 / np.linalg.norm(y_dia[act])))
    return worst, a


def public_api(T, device, model64, struct64, V64):
    """Phase 14: the examples through BilinearForm/LinearForm.  Returns the
    numbers of the phase and the closures that phase 15 times."""
    from ngsxfem_tpu_torch.examples import cutfem, fictdom3d, fictdom_ghostpen
    from ngsxfem_tpu_torch.solvers import ell_spmv

    out = {}
    errs = [fictdom3d.run(nx=nx, verbose=False, device=device)
            for nx in API_NX[:-1]]

    # nx = 48 step by step, as examples.fictdom3d.run does it, so that one
    # assembled system serves the error, both solves and the kernel check
    nx = API_NX[-1]
    a, f, Vh, free, l2error = fictdom3d.system(nx=nx, device=device)
    mesh = Vh.mesh
    check(mesh.ne == 6 * nx**3 and mesh.nv == (nx + 1) ** 3,
          f"fictdom3d mesh ne={mesh.ne} nv={mesh.nv}")
    a.Assemble()
    f.Assemble()
    check(a.mat.vals.is_cuda == (device.type == "cuda")
          and a.mat.vals.dtype == torch.float64, "a.mat is not f64 on the device")
    S = a.mat.to_scipy()
    asym = float(abs(S - S.T).max() / abs(S).max())
    check(asym <= 1e-12, f"a.mat symmetry {asym} of its largest entry")
    ell = a.mat.ell()
    n, K = ell.vals.shape
    out["K"], out["nrows"] = int(K), int(n)
    if device.type == "cuda":
        # kernel B2 against its plain versions on the table, type and
        # vectors this path gives it: f64, K=24, a seeded x and the
        # free-masked load, and its times
        out["b2"] = b2_on_table(f"fictdom3d forms nx={nx}", ell, free.np,
                                f.vec.data, device)
    inv_lu = a.mat.Inverse(free, inverse="umfpack")
    t0 = time.perf_counter()
    x_lu = inv_lu * f.vec.data        # factorizes on the host, then solves
    sync(device)
    out["lu_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inv_lu * f.vec.data               # the factors are kept
    sync(device)
    out["lu_again_s"] = time.perf_counter() - t0
    gfu = T.GridFunction(Vh)
    gfu.vec.data = x_lu
    errs.append(l2error(gfu))
    check(errs[0] < 0.06, f"fictdom3d nx={API_NX[0]} L2 error {errs[0]}")
    eocs = [float(np.log2(errs[i] / errs[i + 1])) for i in range(1, len(errs) - 1)]
    check(min(eocs) >= EOC_MIN, f"fictdom3d L2 errors {errs}: EOC {eocs}")
    out["errs"], out["eocs"] = errs, eocs
    before = ell_spmv.launches
    layouts_before = ell_spmv.layouts_built
    with counted_products("cg") as cnt:
        x_cg = a.mat.Inverse(free, inverse="cg") * f.vec.data
    sync(device)
    out["cg_launches"] = ell_spmv.launches - before
    out["cg_iters"], out["cg_products"] = cnt.iters, cnt.products
    if device.type == "cuda":
        check(out["cg_launches"] == cnt.products > 0,
              f"'cg' solve: {out['cg_launches']} ell_spmv launches for "
              f"{cnt.products} products")
    dsol = float(torch.linalg.vector_norm(x_cg - x_lu)
                 / torch.linalg.vector_norm(x_lu))
    check(dsol <= 1e-8, f"direct vs 'cg' solution: rel {dsol}")
    # the default Inverse(): Jacobi-CG on the card (this SPD free block),
    # the host LU on the CPU; the ELL view's layout is already built
    before = ell_spmv.launches
    t0 = time.perf_counter()
    with counted_products("cg") as cnt:
        inv = a.mat.Inverse(free)
        x_def = inv * f.vec.data
    sync(device)
    out["default_s"] = time.perf_counter() - t0
    out["default_path"] = inv.path
    out["default_launches"] = ell_spmv.launches - before
    out["default_iters"], out["default_products"] = cnt.iters, cnt.products
    out["layouts"] = ell_spmv.layouts_built - layouts_before
    want = int(ell_spmv.uses_layout(a.mat.vals))  # none on the CPU
    check(out["layouts"] == want, f"the 'cg' and default solves built "
                                  f"{out['layouts']} layouts for one table, "
                                  f"{want} expected")
    if device.type == "cuda":
        check(inv.path == "device_cg" and out["default_launches"]
              == cnt.products == cnt.iters + 1,
              f"default Inverse(): path {inv.path}, "
              f"{out['default_launches']} ell_spmv launches for "
              f"{cnt.products} products, {cnt.iters} iterations")
    out["dsol_default"] = float(torch.linalg.vector_norm(x_def - x_lu)
                                / torch.linalg.vector_norm(x_lu))
    check(out["dsol_default"] <= 1e-8,
          f"named LU vs default Inverse() solution: rel {out['dsol_default']}")
    out.update(asym=asym, dsol=dsol, nfree=free.NumSet(),
               ntriplets=int(a.mat.vals.shape[0]), a=a, f=f, free=free)

    # the same integrators on the hand-written model's mesh and level set
    out["vs_model"], _ = forms_vs_model(T, model64, struct64, V64, device)
    check(out["vs_model"] <= 1e-12,
          f"forms operator vs UnfittedPoisson's DIA operator: {out['vs_model']}")

    # the two 2D workloads, card against this host's CPU
    for name, mod, kw in (("fictdom_ghostpen", fictdom_ghostpen, {"nx": 40}),
                          ("cutfem", cutfem, {"nx": 30})):
        e_dev = mod.run(verbose=False, device=device, **kw)
        e_cpu = mod.run(verbose=False, device="cpu", **kw)
        check(abs(e_dev - e_cpu) <= 1e-8 * e_cpu,
              f"{name}: card {e_dev} vs CPU {e_cpu}")
        out[name] = (e_dev, e_cpu)
    check(abs(out["cutfem"][0] - 0.0188) < 5e-4,
          f"cutfem L2 error {out['cutfem'][0]}")
    return out


# --- phases 16-17: skeleton, vector and XFEM workloads --------------------


class counted_products:
    """While active, counts the matrix products and iterations of
    ``krylov.<name>`` (``cg`` or ``minres``), which the solver objects
    call through the module."""

    def __init__(self, name):
        from ngsxfem_tpu_torch.solvers import krylov

        self.mod, self.name = krylov, name
        self.products, self.iters = 0, None

    def __enter__(self):
        self.orig = getattr(self.mod, self.name)

        def run(matvec, *args, **kw):
            def mv(z):
                self.products += 1
                return matvec(z)
            res = self.orig(mv, *args, **kw)
            self.iters = int(res[1])
            return res

        setattr(self.mod, self.name, run)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def event_ms(fn):
    """(fn(), ms by CUDA events) of one call (by the host clock without a
    card, as the CPU rehearsal of the tests runs it)."""
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def b2_timed(label, A, x):
    """Kernel B2 on the ``ELLMatrix`` A with the seeded x: us per call
    (events), device us per launch (``torch.profiler``), the row-major
    kernel it replaced on the same table (device us, equal to the plain
    version under ``torch.equal``), the ms of the kernel's plain version
    ``sell_matvec_plain`` and of ``ell_matvec_plain``, the nnz bound (the
    least time of the function: ``bound_ms`` of the record) and the padded
    one, and cuSPARSE.  Launches and layouts made here are put back."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    import torch_ell_spmv_before_after as before_after
    from ngsxfem_tpu_torch.solvers import ell_spmv
    from ngsxfem_tpu_torch.solvers.sparse import ELLMatrix

    counts = ell_spmv.launches, ell_spmv.layouts_built
    A = ELLMatrix(A.cols, A.vals, A.shape)  # its own layout, not the path's
    n, K = A.vals.shape
    L = A.layout()
    s = A.vals.element_size()
    out = {"label": label, "n": int(n), "K": int(K),
           "dtype": str(A.vals.dtype)[6:], "fill": L.fill, "nnz": L.nnz,
           "slices": slice_stats(L)}
    out["ms"] = per_call_ms(lambda: A @ x, 100)
    out["dev_us"] = before_after.device_us(lambda: A @ x,
                                           before_after.NEW_KERNEL)
    old = before_after.load_rowmajor()
    y_old = before_after.rowmajor_matvec(old, A.vals, A.cols, x)
    check(torch.equal(y_old, ell_spmv.ell_matvec_plain(A.vals, A.cols, x)),
          f"{label}: the row-major kernel != plain")
    out["before_us"] = before_after.device_us(
        lambda: before_after.rowmajor_matvec(old, A.vals, A.cols, x),
        before_after.OLD_KERNEL)
    out["plain_ms"] = per_call_ms(
        lambda: ell_spmv.sell_matvec_plain(L, x), 5)
    out["plain_ell_ms"] = per_call_ms(
        lambda: ell_spmv.ell_matvec_plain(A.vals, A.cols, x), 5)
    out["bound"] = nnz_bound(L.nnz, n, A.shape[1], s)
    out["bound_padded"] = ell_bound(n, K, A.shape[1], s)
    rid = torch.arange(n, device=x.device)[:, None].expand(n, K)
    with warnings.catch_warnings():  # "beta state" notices of torch.sparse
        warnings.simplefilter("ignore")
        csr = torch.sparse_coo_tensor(
            torch.stack([rid.reshape(-1), A.cols.reshape(-1).long()]),
            A.vals.reshape(-1), A.shape).coalesce().to_sparse_csr()
    y_lib = csr @ x
    y_k = A @ x
    lib_rel = float(torch.linalg.vector_norm(y_lib - y_k)
                    / torch.linalg.vector_norm(y_lib))
    check(lib_rel <= (1e-12 if s == 8 else 1e-5),
          f"{label}: cuSPARSE yardstick rel {lib_rel}")
    out["lib_ms"] = per_call_ms(lambda: csr @ x, 100)
    kern, _ = device_kernels(lambda: csr @ x, 20)
    out["lib_dev_us"] = sum(us for _, us in kern.values()) / 20 if kern else None
    ell_spmv.launches, ell_spmv.layouts_built = counts
    return out


def b2_text(b2):
    """One log clause of ``b2_timed``'s numbers."""
    return (f"{b2['dev_us']:.3f} us device per launch "
            f"({b2['ms'] * 1e3:.3f} us per call), the row-major kernel it "
            f"replaced {b2['before_us']:.3f} us device, plain "
            f"sell_matvec_plain {b2['plain_ms'] * 1e3:.3f} us and "
            f"ell_matvec_plain {b2['plain_ell_ms'] * 1e3:.3f} us, bound nnz "
            f"{b2['bound'][0] * 1e3:.3f} us ({b2['bound'][1]}), bound padded "
            f"{b2['bound_padded'][0] * 1e3:.3f} us "
            f"({b2['bound_padded'][1]}), "
            f"cuSPARSE {b2['lib_dev_us']} us device "
            f"({b2['lib_ms'] * 1e3:.3f} us per call); {b2['slices']}")


def b2_record(b2):
    """B2's numbers on one table for the kernel record."""
    return {"table": b2["label"], "n": b2["n"], "K": b2["K"],
            "dtype": b2["dtype"], "max_abs_err": b2["err"], "ms": b2["ms"],
            "device_us": b2["dev_us"], "before_us": b2["before_us"],
            "plain_ms": b2["plain_ms"], "plain_ell_ms": b2["plain_ell_ms"],
            "bound_ms": b2["bound"][0], "bound_by": b2["bound"][1],
            "bound_nnz_ms": b2["bound"][0],
            "bound_padded_ms": b2["bound_padded"][0],
            "slice_fill": b2["fill"], "library_ms": b2["lib_ms"],
            "library_device_us": b2["lib_dev_us"]}


def b2_on_table(label, ell, free, load, device):
    """Kernel B2 against its plain versions on an assembled table, with a
    seeded x and with the free-masked load, and ``b2_timed`` on it."""
    rng = np.random.default_rng(2030)
    xs = torch.as_tensor(rng.standard_normal(ell.shape[1]),
                         dtype=ell.vals.dtype, device=device)
    fm = torch.as_tensor(free, device=device)
    xf = torch.where(fm, load, 0.0).contiguous()
    err, _ = ell_kernel_vs_plain([(f"{label} seeded x", ell.vals, ell.cols,
                                   xs),
                                  (f"{label} masked load", ell.vals,
                                   ell.cols, xf)])
    out = b2_timed(label, ell, xs)
    out["err"] = err
    return out


def card_size(name, build, device, lift=None, minres_pre=None):
    """One workload at its card size, built once through its module's
    ``system()`` (``build()`` returns its tuple): ``Assemble`` (seconds by
    the host clock), ``to_ell`` (host numpy), B2 on the table, the device
    solve (``Inverse(free, inverse="cg")``, or ``MinResSolver`` with the
    preconditioner ``minres_pre(a, parts)``) with its ell_spmv launches
    against the solver's products, the true residual and the L2 error.
    ``lift(parts)`` gives the GridFunction holding Dirichlet data, if any.
    Returns the numbers and what phase 17 profiles."""
    from ngsxfem_tpu_torch import CGSolver, GridFunction, MinResSolver
    from ngsxfem_tpu_torch.solvers import ell_spmv
    from ngsxfem_tpu_torch.solvers.sparse import _as_array

    out = {"name": name, "nx": BIG_NX[name]}
    t0 = time.perf_counter()
    parts = build()
    a, f, V, free, error = parts[:5]
    sync(device)
    out["system_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    a.Assemble()
    f.Assemble()
    sync(device)
    out["assemble_s"] = time.perf_counter() - t0
    out["ntriplets"] = int(a.mat.vals.shape[0])
    t0 = time.perf_counter()
    ell = a.mat.ell()  # the cached ELL view: to_ell on the host, once
    sync(device)
    out["to_ell_s"] = time.perf_counter() - t0
    lift = None if lift is None else lift(parts)
    rhs = f.vec.data if lift is None else f.vec.data - a.mat * lift.vec.data
    free_np = free.np
    out["nfree"] = int(free_np.sum())
    if device.type == "cuda":
        out["b2"] = b2_on_table(f"{name} nx={out['nx']}", ell, free_np, rhs,
                                device)
    before = ell_spmv.launches
    layouts_before = ell_spmv.layouts_built
    if minres_pre is None:
        solver = a.mat.Inverse(free, inverse="cg")
        kind = "cg"
    else:
        pre = minres_pre(a, parts)
        solver = MinResSolver(a.mat, pre=pre, freedofs=free, maxsteps=50000,
                              tol=1e-12)
        kind = "minres"
    with counted_products(kind) as cnt:
        x, out["solve_ms"] = event_ms(lambda: solver * rhs)
    out["launches"] = ell_spmv.launches - before
    out["layouts"] = ell_spmv.layouts_built - layouts_before
    out["kind"], out["iters"], out["products"] = kind, cnt.iters, cnt.products
    want = int(ell_spmv.uses_layout(a.mat.vals))  # none on the CPU
    check(out["layouts"] == want, f"{name}: the solve built "
                                  f"{out['layouts']} layouts for its one "
                                  f"table, {want} expected")
    if device.type == "cuda":
        check(out["launches"] == cnt.products == cnt.iters + 1,
              f"{name}: {out['launches']} ell_spmv launches, "
              f"{cnt.products} products, {cnt.iters} iterations")
    fm = torch.as_tensor(free_np, device=device)
    r = torch.where(fm, _as_array(rhs) - a.mat * x, 0.0)
    out["true_rel"] = float(torch.linalg.vector_norm(r)
                            / torch.linalg.vector_norm(torch.where(fm, rhs, 0.0)))
    gfu = GridFunction(V)
    gfu.vec.data = x if lift is None else lift.vec.data + x
    out["err"] = error(gfu)
    out["peak_gib"] = peak_gib(device)
    out["a"], out["f"], out["solver"], out["rhs"] = a, f, solver, rhs
    # the same solver for WINDOW iterations on its tolerance path (a
    # tolerance it cannot reach): what phase 17 profiles
    out["window"] = (MinResSolver(a.mat, pre=solver.pre, freedofs=free,
                                  maxsteps=WINDOW, tol=1e-300)
                     if kind == "minres" else
                     CGSolver(a.mat, freedofs=free, maxsteps=WINDOW,
                              tol=1e-300))
    return out


def skeleton_slice(T, device):
    """Phase 16: the DG, dn-ghost-penalty, cut Stokes, Nitsche-XFEM and
    XFESpace workloads at their reference tests' sizes (card against this
    host's CPU, the tests' thresholds), then each at its card size."""
    from ngsxfem_tpu_torch.examples import (fictdom_dg_ghostpen,
                                            fictdom_dn_ghostpen, nxfem,
                                            stokescutfem, xfespaces)

    out = {}

    def card_vs_cpu(name, fn):
        e_dev, e_cpu = fn(device), fn(torch.device("cpu"))
        for a, b in zip(np.atleast_1d(e_dev), np.atleast_1d(e_cpu)):
            check(abs(a - b) <= 1e-8 * abs(b), f"{name}: card {e_dev} vs CPU "
                                               f"{e_cpu}")
        out[name] = (e_dev, e_cpu)
        return e_dev

    # DG fictitious domain, order 2 (tests/test_workloads.py:74-83)
    e_dg = [card_vs_cpu(f"dg nx={nx}", lambda d, nx=nx: fictdom_dg_ghostpen.run(
        nx=nx, order=2, verbose=False, device=d)) for nx in DG_NX]
    out["dg"] = e_dg
    check(e_dg[1] < DG_MAX and e_dg[1] < e_dg[0] / DG_RATE,
          f"DG L2 errors {e_dg}")
    # dn-jump ghost penalty, order 1 (tests/test_ghostpenalty.py:13-18)
    e_dn = card_vs_cpu(f"dn nx={DN_NX}", lambda d: fictdom_dn_ghostpen.run(
        nx=DN_NX, order=1, verbose=False, device=d))
    check(e_dn < DN_MAX, f"dn ghost penalty L2 error {e_dn}")
    out["dn"] = e_dn
    # Nitsche-XFEM, order 1 (tests/test_workloads.py:199-205)
    e_nx = card_vs_cpu(f"nxfem nx={NXF_NX}", lambda d: nxfem.run(
        nx=NXF_NX, verbose=False, device=d))
    check(e_nx < NXF_MAX, f"nxfem L2 error {e_nx}")
    out["nxfem"] = e_nx
    # the XFESpace demo: every number equal on card and CPU
    nums = [xfespaces.system(device=d) for d in (device, torch.device("cpu"))]
    for k in nums[1]:
        a, b = np.asarray(nums[0][k], float), np.asarray(nums[1][k], float)
        check(np.all(np.abs(a - b) <= 1e-12 * np.maximum(np.abs(b), 1.0)),
              f"xfespaces {k}: card {nums[0][k]} vs CPU {nums[1][k]}")
    out["xfespaces"] = nums[0]

    # the "cg" solve at nx=64 against the host LU (nxfem)
    a, f, VhG, free, _, lift = nxfem.system(nx=NXF_LU_NX, device=device)
    a.Assemble()
    f.Assemble()
    rhs = f.vec.data - a.mat * lift.vec.data
    x_lu = a.mat.Inverse(free, inverse="umfpack") * rhs
    x_cg = a.mat.Inverse(free, inverse="cg") * rhs
    out["nxfem_lu_cg"] = float(torch.linalg.vector_norm(x_cg - x_lu)
                               / torch.linalg.vector_norm(x_lu))
    check(out["nxfem_lu_cg"] <= 1e-8,
          f"nxfem nx={NXF_LU_NX}: 'cg' vs LU rel {out['nxfem_lu_cg']}")

    # cut Stokes, P2/P1 (tests/test_stokes.py:11-21): nx=16 by run(); nx=32
    # built once: the host LU and MINRES on the card, equal to 1e-8
    u16, p16 = card_vs_cpu(f"stokes nx={ST_NX[0]}", lambda d: stokescutfem.run(
        nx=ST_NX[0], verbose=False, device=d))
    check(u16 < ST_MAX[0] and p16 < ST_MAX[1],
          f"Stokes nx={ST_NX[0]} errors {u16}, {p16}")
    out["stokes"] = (u16, p16)
    a, f, X, act, errors, pmass = stokescutfem.system(nx=ST_NX[1],
                                                      device=device)
    a.Assemble()
    f.Assemble()
    pmass.Assemble()
    x_lu = a.mat.Inverse(act, inverse="umfpack") * f.vec
    with counted_products("minres") as cnt:
        x_mr = T.MinResSolver(a.mat, pre=stokescutfem.minres_preconditioner(
            a, pmass, X, act), freedofs=act, maxsteps=50000, tol=1e-12) * f.vec
    errs = []
    for xs in (x_lu, x_mr):
        gf = T.GridFunction(X)
        gf.vec.data = xs
        errs.append(errors(gf))
    (u32, p32), (u32m, p32m) = errs
    vel = X.Range(0)
    dvel = float(torch.linalg.vector_norm(x_mr[vel] - x_lu[vel])
                 / torch.linalg.vector_norm(x_lu[vel]))
    check(u32 < u16 / ST_RATE[0] and p32 < p16 / ST_RATE[1],
          f"Stokes convergence {(u16, p16)} -> {(u32, p32)}")
    check(dvel <= 1e-8 and abs(u32m - u32) <= 1e-8 * u32
          and abs(p32m - p32) <= 1e-8 * p32,
          f"Stokes nx=32 MINRES vs LU: velocity rel {dvel}, errors "
          f"{(u32m, p32m)} vs {(u32, p32)}")
    out["stokes32"] = (u32, p32, dvel, abs(u32m - u32) / u32,
                       abs(p32m - p32) / p32, cnt.iters)

    def stokes_pre(a, parts):
        _, _, X, act, _, pmass = parts
        pmass.Assemble()
        return stokescutfem.minres_preconditioner(a, pmass, X, act)

    # the card sizes, each built once through system()
    bigs = [
        card_size("fictdom_dg_ghostpen", lambda: fictdom_dg_ghostpen.system(
            nx=BIG_NX["fictdom_dg_ghostpen"], order=2, device=device), device),
        card_size("fictdom_dn_ghostpen", lambda: fictdom_dn_ghostpen.system(
            nx=BIG_NX["fictdom_dn_ghostpen"], order=1, device=device), device),
        card_size("stokescutfem", lambda: stokescutfem.system(
            nx=BIG_NX["stokescutfem"], device=device), device,
            minres_pre=stokes_pre),
        card_size("nxfem", lambda: nxfem.system(nx=BIG_NX["nxfem"],
                                                device=device), device,
                  lift=lambda parts: parts[5]),
    ]
    dg, dn, st, nxf = bigs
    check(dg["err"] < e_dg[1], f"DG nx={dg['nx']} L2 {dg['err']} >= "
                               f"nx={DG_NX[1]} {e_dg[1]}")
    check(dn["err"] < e_dn, f"dn nx={dn['nx']} L2 {dn['err']} >= "
                            f"nx={DN_NX} {e_dn}")
    check(st["err"][0] < u32 and st["err"][1] < p32,
          f"Stokes nx={st['nx']} errors {st['err']} vs nx={ST_NX[1]} "
          f"{(u32, p32)}")
    check(nxf["err"] < e_nx, f"nxfem nx={nxf['nx']} L2 {nxf['err']} >= "
                             f"nx={NXF_NX} {e_nx}")
    for b in bigs:
        check(b["true_rel"] <= 1e-8, f"{b['name']} nx={b['nx']}: true "
                                     f"relative residual {b['true_rel']}")
    out["bigs"] = bigs
    return out


def peak_gib(device):
    """Peak device memory since the last call, in GiB (0 on the CPU)."""
    if device.type != "cuda":
        return 0.0
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def profiled(fn, reps=5):
    """(median ms by CUDA events over `reps` calls, device kernels, device
    busy ms, idle share, the three kernels with the most device time) of one
    call of `fn`."""
    ms = time_ms(fn, reps)
    kern, wall = device_kernels(fn, 1, warm=False)
    busy = sum(us for _, us in kern.values()) / 1e3
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:3]
    return (ms, sum(c for c, _ in kern.values()), busy, 1 - busy / wall,
            "; ".join(f"{k[:50]} x{c} {us / 1e3:.3f} ms" for k, (c, us) in top))


def phases_16_17(T, dev, t_start):
    """Phases 16 (skeleton, vector and XFEM workloads, launch counters reset
    just before them) and 17 (their card-size calls profiled).  Returns the
    phase-16 numbers and the ell_spmv launches of its path."""
    from ngsxfem_tpu_torch.solvers import dia_cg, ell_spmv

    torch.cuda.synchronize()
    peak_gib(dev)
    dia_cg.launches = 0
    ell_spmv.launches = 0
    t0 = time.perf_counter()
    sk = skeleton_slice(T, dev)
    sk_launches = ell_spmv.launches
    check(sk_launches > 0, "the skeleton/XFEM path launched ell_spmv no time")
    u32, p32, dvel, du, dp, mr32 = sk["stokes32"]
    print(f"[16 reference sizes] card (CPU): fictdom_dg_ghostpen order 2 "
          f"nx={list(DG_NX)} L2 "
          + ", ".join(f"{sk[f'dg nx={nx}'][0]:.10e} ({sk[f'dg nx={nx}'][1]:.10e})"
                      for nx in DG_NX)
          + f"; fictdom_dn_ghostpen nx={DN_NX} L2 {sk[f'dn nx={DN_NX}'][0]:.10e} "
          f"({sk[f'dn nx={DN_NX}'][1]:.10e}); nxfem nx={NXF_NX} L2 "
          f"{sk[f'nxfem nx={NXF_NX}'][0]:.10e} "
          f"({sk[f'nxfem nx={NXF_NX}'][1]:.10e}), nx={NXF_LU_NX} 'cg' vs LU "
          f"rel {sk['nxfem_lu_cg']:.3e}; stokescutfem nx={ST_NX[0]} u/p L2 "
          f"{sk['stokes'][0]:.6e}/{sk['stokes'][1]:.6e}, "
          f"nx={ST_NX[1]} {u32:.6e}/{p32:.6e}, MINRES ({mr32} iterations) vs "
          f"LU: velocity rel {dvel:.3e}, u/p errors rel {du:.3e}/{dp:.3e}; "
          f"xfespaces {sk['xfespaces']}", flush=True)
    for b in sk["bigs"]:
        b2 = b["b2"]
        print(f"[16 card size] {b['name']} nx={b['nx']}: {b['nfree']} free "
              f"dofs, {b['ntriplets']} COO triplets, ELL {b2['n']} x "
              f"{b2['K']} {b2['dtype']}; system() {b['system_s']:.2f} s, "
              f"Assemble (a and f) {b['assemble_s']:.2f} s, to_ell "
              f"{b['to_ell_s']:.2f} s (host); {b['kind']} solve "
              f"{b['iters']} iterations = {b['products']} products = "
              f"{b['launches']} ell_spmv launches, {b['layouts']} layout "
              f"built, {b['solve_ms']:.1f} ms, true rel res "
              f"{b['true_rel']:.3e}; L2 error {b['err']}; B2 on this table "
              f"== plain bitwise (seeded x, masked load, max|dy| "
              f"{b2['err']:.3e}), {b2_text(b2)}; peak memory "
              f"{b['peak_gib']:.2f} GiB", flush=True)
    print(f"[16 launches] ell_spmv {sk_launches}, dia_cg {dia_cg.launches}; "
          f"wall of phase 16 {time.perf_counter() - t0:.2f} s", flush=True)

    # 17. the card-size calls of phase 16 on the card: one call each by CUDA
    # events, one under torch.profiler; the solves over a window of WINDOW
    # iterations of the same solver
    t0 = time.perf_counter()
    for b in sk["bigs"]:
        tag = f"{b['name']} nx={b['nx']}"
        for what, fn in (("BilinearForm.Assemble", b["a"].Assemble),
                         ("LinearForm.Assemble", b["f"].Assemble)):
            _, ms = event_ms(fn)
            kern, wall = device_kernels(fn, 1, warm=False)
            busy = sum(us for _, us in kern.values()) / 1e3
            print(f"[17 times] {card()} | {what} {tag}: {ms:.3f} ms, "
                  f"{sum(c for c, _ in kern.values())} device kernels, device "
                  f"busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}, host "
                  f"(not device-busy) {(ms - busy) / 1e3:.3f} s", flush=True)
        window, rhs = b["window"], b["rhs"]
        _, wms = event_ms(lambda: window * rhs)
        kern, wall = device_kernels(lambda: window * rhs, 1, warm=False)
        busy = sum(us for _, us in kern.values()) / 1e3
        nk = sum(c for c, _ in kern.values())
        print(f"[17 times] {card()} | {b['kind']} solve {tag}: "
              f"{b['solve_ms']:.3f} ms for {b['iters']} iterations (phase 16); "
              f"a {WINDOW}-iteration window {wms:.3f} ms, {nk} device kernels "
              f"({nk / WINDOW:.1f} per iteration), device busy {busy:.3f} ms, "
              f"idle share {1 - busy / wall:.3f}; to_ell {b['to_ell_s']:.3f} s "
              f"(host numpy); peak memory {b['peak_gib']:.2f} GiB", flush=True)
    print(f"[17 times] peak memory {peak_gib(dev):.2f} GiB | wall of phase 17 "
          f"{time.perf_counter() - t0:.2f} s, of the whole run "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)

    return sk, sk_launches


def main():
    # 1. environment
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from ngsxfem_tpu_torch.kernels import build
    from ngsxfem_tpu_torch.solvers import dia_cg, ell_spmv
    from ngsxfem_tpu_torch.solvers.krylov import cg, cg_ir
    from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

    t_start = time.perf_counter()
    gpu = card()
    dev = torch.device("cuda", 0)
    print(f"[1 env] {gpu} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| devices {torch.cuda.device_count()}", flush=True)

    # 2. build, one nvcc per source, all started together: the two kernels
    # and the row-major ELL kernel that B2 replaced (the "before" of its
    # timings)
    t0 = time.perf_counter()
    rowmajor = os.path.join(TOOLS, "torch_ell_spmv_rowmajor.cu")
    built = build.build_all(["dia_cg", "ell_spmv", "ell_spmv_rowmajor"],
                            {"ell_spmv_rowmajor": rowmajor})
    parts = []
    for name, (so, build_s, log) in built.items():
        regs = sorted({ln.split("Used ")[1].split(" registers")[0]
                       for ln in log.splitlines() if "registers" in ln})
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln})
        parts.append(f"{name} -> {so.rsplit('/', 1)[-1]} in "
                     f"{build_s:.2f} s (registers per kernel: "
                     f"{', '.join(regs) or 'reused build'}; "
                     f"{' / '.join(spills) or 'no spill report'})")
    b2_info = ell_spmv.kernel_info(dev)
    print(f"[2 build] B2 sell32_spmv_kernel (registers, static shared memory "
          f"B, local memory B per thread): f32 {b2_info['float32']}, f64 "
          f"{b2_info['float64']}", flush=True)
    info = dia_cg.device_info(dev)
    print(f"[2 build] {'; '.join(parts)}; wall {time.perf_counter() - t0:.2f} s"
          f" | dia_cg kernel: {info['registers']} registers, "
          f"{info['static_smem']} B static shared memory, {info['local_bytes']}"
          f" B local memory per thread; {info['sm_count']} SMs, "
          f"{info['smem_bytes']} B dynamic shared memory per block, "
          f"cooperative launch {bool(info['cooperative'])}", flush=True)

    # 3. kernel against its plain version on the card
    t0 = time.perf_counter()
    before = dia_cg.launches
    cases = []
    plans = []
    kept = {}  # nx -> lattice level, reused by phase 12
    for nx in KERNEL_NX:
        m3, struct, V, _, b, dinv, _ = flagship(nx, dev)
        kept[nx] = lattice_level(m3, struct, V)
        offs = struct["offsets"]
        cases += dia_kernel_vs_plain(f"nx={nx}", offs, V, b, dinv, KERNEL_ITERS)
        if nx >= NX:
            plans.append(f"nx={nx} n={V.shape[1]}: "
                         + dia_cg.cuda_plan(offs, V.shape[1], dev).describe())
    rng = np.random.default_rng(2027)
    for dim in (1, 2, 3):
        for n in (1, 257, 100_003):
            offs = lattice_offsets(dim, max(2, round(n ** (1 / dim))))
            cases += dia_kernel_vs_plain(f"random {dim}D n={n}", offs,
                                         *random_dia(rng, n, offs, dev),
                                         KERNEL_ITERS)
    # larger than the shared memory of the grid: only part of the operator
    # (coefficients, the vectors, then the p window) is staged
    for n, w in ((1_000_003, 101), (2_146_689, 129)):
        offs = lattice_offsets(3, w)
        plan = dia_cg.cuda_plan(offs, n, dev)
        check(plan.staged_terms < len(offs), f"n={n}: the plan stages all")
        plans.append(f"random 3D n={n}: " + plan.describe())
        cases += dia_kernel_vs_plain(f"random 3D n={n}", offs,
                                     *random_dia(rng, n, offs, dev), (1, 12))
    try:
        dia_cg.dia_cg_fused([-1, 0, 2], V[:3], b, dinv, 1)
    except ValueError:
        pass
    else:
        raise RuntimeError("check failed: asymmetric offsets did not raise")
    check(dia_cg.launches > before, "kernel launch counter did not move")
    worst_rel = max(c[2] for c in cases)
    worst_abs = max(c[3] for c in cases)
    n_bitwise = sum(1 for c in cases if c[3] == 0.0)
    max_abs_err = max(c[3] for c in cases if c[0] == f"nx={NX}")
    print(f"[3 kernel] {len(cases)} cases (flagship nx={list(KERNEL_NX)} "
          f"and seeded random tables, iters {list(KERNEL_ITERS)}): worst rel "
          f"{worst_rel:.3e} <= {KERNEL_TOL}, max|x_k - x_p| {worst_abs:.3e} "
          f"(at nx={NX} {max_abs_err:.3e}), kernel == plain bitwise in "
          f"{n_bitwise}/{len(cases)} cases, bitwise repeatable, asymmetric "
          f"offsets raise, {dia_cg.launches - before} launches, "
          f"wall {time.perf_counter() - t0:.2f} s", flush=True)
    for line in plans:
        print(f"[3 plan] {line}", flush=True)
    del V, b, dinv, m3

    # 4. the DIA path, launch counters reset just before it
    dia_cg.launches = 0
    ell_spmv.launches = 0
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
    check(launches > 0, "the DIA path launched the dia_cg kernel no time")

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
    t0 = time.perf_counter()
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
    dev_us = {}
    for iters in (0, CG_ITERS):
        kern, _ = device_kernels(
            lambda it=iters: dia_cg.dia_cg_fused(offs, V, b, dinv, it), 5)
        names = list(kern)
        check(len(names) == 1 and "dia_cg" in names[0] and kern[names[0]][0] == 5,
              f"PCG-{iters}: expected one dia_cg device kernel per call, got "
              f"{ {k[:60]: c for k, (c, _) in kern.items()} }")
        dev_us[iters] = kern[names[0]][1] / 5
    per_iter_us = (dev_us[CG_ITERS] - dev_us[0]) / CG_ITERS
    print(f"[5 times] {card()} | host setup {setup_s:.3f} s | assembly "
          f"{asm_ms:.3f} ms | PCG-{CG_ITERS} kernel {pcg_ms:.3f} ms | "
          f"PCG-{CG_ITERS} plain (dia_cg_fused_plain) {plain_ms:.3f} ms | "
          f"PCG-{CG_ITERS} krylov.cg+dia_matvec {cg_ms:.3f} ms | cg_ir "
          f"{ir_ms:.3f} ms | assembly+PCG-{CG_ITERS} {eps:.4g} elements/s",
          flush=True)
    print(f"[5 pcg profile] {card()} | one dia_cg device kernel per call | "
          f"device time PCG-{CG_ITERS} {dev_us[CG_ITERS]:.3f} us, PCG-0 "
          f"{dev_us[0]:.3f} us, per iteration {per_iter_us:.3f} us "
          f"({dia_cg.cuda_plan(offs, model.ndof, dev).barriers_per_iter} grid "
          f"barriers per iteration) | wall {time.perf_counter() - t0:.2f} s",
          flush=True)

    # 6. the ELL kernel against its plain versions on the card
    before = ell_spmv.launches
    t0 = time.perf_counter()
    st48 = model.ell_structure()
    V48, _ = model.assemble_vals_soa1(model.vertices, model.lset, st48)
    cols48 = torch.as_tensor(st48["ell_cols"], device=dev)
    rng = np.random.default_rng(2026)
    x48 = rng.standard_normal(model.ndof)
    cases = [(f"nx={NX} {dt}", V48.to(dt).contiguous(), cols48,
              torch.as_tensor(x48, dtype=dt, device=dev))
             for dt in (torch.float32, torch.float64)]
    ell_err, L48 = ell_kernel_vs_plain(cases[:1])
    for dt in (torch.float32, torch.float64):
        for K in (1, 2, 3, 7, 16, 25, 32, 60, 64):
            for n in (0, 1, 31, 32, 33, 257, 100_003):
                cases.append((f"random n={n} K={K} {dt}",
                              *random_ell(rng, n, K, n + 5, dt, dev)))
        cases.append((f"NaN-poisoned n=1000 K=24 {dt}",
                      *random_ell(rng, 1000, 24, 1005, dt, dev, nan=True)))
    ell_err = max(ell_err, ell_kernel_vs_plain(cases)[0])
    vals32, _, x32 = cases[0][1:]
    vn, cn, xn = cases[-1][1:]
    yn = ell_spmv.ell_matvec(vn, cn, xn)  # a raw call: a throwaway layout
    check(bool(torch.isnan(yn).all()), "a NaN-poisoned table's product "
                                       "is not NaN in every row")
    built_before = ell_spmv.layouts_built
    ell_spmv.ell_matvec(vals32, cols48, x32)
    check(ell_spmv.layouts_built == built_before + 1,
          "a raw CUDA call did not build (and count) a layout")
    for what, args in (
            ("int64 cols", (vals32, cols48.long(), x32)),
            ("wrong shape", (vals32, cols48[:-1], x32)),
            ("CPU x with CUDA vals", (vals32, cols48, x32.cpu())),
            ("a layout of another table", (vals32[:-1].contiguous(),
                                           cols48[:-1].contiguous(),
                                           x32, L48))):
        try:
            ell_spmv.ell_matvec(*args)
        except ValueError:
            pass
        else:
            raise RuntimeError(f"check failed: {what} did not raise")
    check(ell_spmv.launches > before, "ell_spmv launch counter did not move")
    print(f"[6 ell kernel] nx={NX} ELL {tuple(V48.shape)} f32+f64 and "
          f"{len(cases) - 2} seeded tables (K=1..64, n=0..100,003, rows of "
          f"varying length in each slice, all-padding rows, NaN-poisoned): "
          f"kernel == sell_matvec_plain bit for bit, == ell_matvec_plain "
          f"(torch.equal; max|dy| {ell_err:.3e}), bitwise repeatable, bad "
          f"inputs raise, a raw call builds its layout; nx={NX} f32 layout: "
          f"{slice_stats(L48)}; {ell_spmv.launches - before} launches, "
          f"wall {time.perf_counter() - t0:.2f} s", flush=True)
    del cases, V48, cols48, L48, vn, cn, xn

    # 7. the ELL path, launch counters reset just before it.  Its tables
    # are assembled as a user's call assembles them, in a fixed order
    # (ScatterPlan), with no global flag set.
    dia_cg.launches = 0
    ell_spmv.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ell = ell_path(dev, model, dict(struct, V=V), x)
    ell_main_s = time.perf_counter() - t0
    ell_launches = ell_spmv.launches
    dia_launches_ell = dia_cg.launches
    check(ell_launches > 0, "the ELL path launched the ell_spmv kernel no time")
    fine = ell["levels"][-1]
    check(int(fine["ncut"]) == ncut_host,
          f"ELL ncut {int(fine['ncut'])} != host count {ncut_host}")
    check(ell["rel_op"] <= ELL_DIA_TOL,
          f"ELL vs DIA operator: rel {ell['rel_op']}")
    check(ell["rel_dia_ell"] <= ELL_DIA_TOL,
          f"ELL form of the DIA table vs DIA operator: rel {ell['rel_dia_ell']}")
    check(ell["rel_cg"] <= KERNEL_TOL,
          f"Jacobi-CG-{CG_ITERS} on ELL vs dia_cg kernel: rel {ell['rel_cg']}")
    b_ell, x_mg = ell["b"], ell["x"]
    bn_ell = float(torch.linalg.vector_norm(b_ell))
    mg_rel = float(ell["res"]) / bn_ell
    check(np.isfinite(mg_rel) and mg_rel <= MG_TOL,
          f"MG-CG recursion rel res {mg_rel} > {MG_TOL}")
    check(ell["iters"] <= MG_MAX_ITERS,
          f"MG-CG took {ell['iters']} > {MG_MAX_ITERS} iterations")
    A = ell["A"]
    r64 = b_ell.double() - ell_spmv.ell_matvec(A.vals.double(), A.cols,
                                               x_mg.double())
    true_rel = float(torch.linalg.vector_norm(r64)
                     / torch.linalg.vector_norm(b_ell.double()))
    check(true_rel <= MG_TRUE_TOL, f"MG-CG true f64 rel res {true_rel}")
    print(f"[7 ell path] levels nx={list(MG_NX)} ndof="
          f"{[lv['model'].ndof for lv in ell['levels']]} ELL K="
          f"{[lv['struct']['K'] for lv in ell['levels']]}, ncut {int(fine['ncut'])}, "
          f"ELL vs DIA operator rel {ell['rel_op']:.3e}, Jacobi-CG-{CG_ITERS} "
          f"vs dia_cg kernel: on the ELL form of the DIA table rel "
          f"{ell['rel_cg']:.3e}, on the assembled ELL table rel "
          f"{ell['rel_cg_asm']:.3e} (true rel res {ell['res50'][1]:.4e} vs "
          f"the kernel's {ell['res50'][0]:.4e}), MG-CG "
          f"{ell['iters']} iterations to rel res {mg_rel:.3e}, true f64 rel "
          f"res {true_rel:.3e}, ell_spmv launches {ell_launches}, dia_cg "
          f"launches {dia_launches_ell}, host: levels {ell['levels_s']:.2f} s, "
          f"MG setup {ell['mg_setup_s']:.2f} s, prepare_host "
          f"{ell['prepare_s']:.3f} s, wall {ell_main_s:.2f} s", flush=True)
    t0 = time.perf_counter()
    rep_iters = repeat_assembly(ell)
    print(f"[7 repeat] assemble_vals_soa1 nx={NX} f32 five more times on the "
          f"card, no global flag: every table bitwise equal to the first; "
          f"MG-CG iterations {rep_iters}; the MG-CG solve built "
          f"{ell['layouts']} layouts for its {ell['layouts']} tables, none "
          f"per product; wall {time.perf_counter() - t0:.2f} s", flush=True)

    # 8. ELL-path times on the card
    t0 = time.perf_counter()
    xr = ell["xr"]
    b2_48 = b2_timed(f"flagship ELL nx={NX} f32", A, xr)
    b2_48["err"] = ell_err
    n, K = A.vals.shape
    asm_lv_ms = [time_ms(lambda lv=lv: lv["model"].assemble_vals_soa1(
        lv["model"].vertices, lv["model"].lset, lv["struct"]))
        for lv in ell["levels"]]
    asm_txt = ", ".join(f"nx={lv['nx']} {t:.3f} ms"
                        for lv, t in zip(ell["levels"], asm_lv_ms))
    mgcg_ms = time_ms(ell["mgcg"], reps=3)
    kern, mg_wall = device_kernels(ell["mgcg"], 1)
    mg_busy = sum(us for _, us in kern.values()) / 1e3
    mg_kernels = sum(c for c, _ in kern.values())
    mg_top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:4]
    ell_spmv.launches = 0
    dia_cg.launches = 0
    ell["mgcg"]()
    per_solve = {"ell_spmv": ell_spmv.launches, "dia_cg": dia_cg.launches}
    print(f"[8 ell times] {card()} | ELL SpMV nx={NX} ({n} x {K} f32): "
          f"{b2_text(b2_48)} | assembly_soa1 per level {asm_txt} "
          f"| prepare_host {ell['prepare_s']:.3f} s | MG-CG {mgcg_ms:.3f} ms, "
          f"{ell['iters']} iterations | launches per MG-CG solve {per_solve}, "
          f"layouts built by the solve path {ell['layouts']} "
          f"(= its tables)", flush=True)
    fl = ell["levels"][-1]
    kern, asm_wall = device_kernels(lambda: fl["model"].assemble_vals_soa1(
        fl["model"].vertices, fl["model"].lset, fl["struct"]), 1)
    asm_busy = sum(us for _, us in kern.values()) / 1e3
    print(f"[8 assembly profile] assemble_vals_soa1 nx={NX}: "
          f"{sum(c for c, _ in kern.values())} device kernels, device busy "
          f"{asm_busy:.3f} ms of {asm_wall:.3f} ms wall (idle share "
          f"{1 - asm_busy / asm_wall:.3f})", flush=True)
    print(f"[8 mg-cg profile] one solve: {mg_kernels} device kernels, device "
          f"busy {mg_busy:.3f} ms of {mg_wall:.3f} ms wall (idle share "
          f"{1 - mg_busy / mg_wall:.3f}); top kernels by device time: "
          + "; ".join(f"{k[:60]} x{c} {us / 1e3:.3f} ms" for k, (c, us) in mg_top)
          + f"; wall of phase 8 {time.perf_counter() - t0:.2f} s", flush=True)

    # 9. general cut quadrature and Integrate on the card (f64)
    import ngsxfem_tpu_torch as T

    del ell
    torch.cuda.synchronize()
    peak_gib(dev)
    t0 = time.perf_counter()
    n_exact, worst_exact = cut_exactness(dev)
    exact_s = time.perf_counter() - t0
    print(f"[9 exactness] {n_exact} cases of the reference suite (segm/trig/"
          f"quad/tet/hex, orders 2-8, NEG/POS/IF, eps-challenges, TPMC, the "
          f"plane on 256 x 256 trig and quad meshes): worst error / bound "
          f"{worst_exact:.3e}, peak memory {peak_gib(dev):.2f} GiB, wall "
          f"{exact_s:.2f} s", flush=True)
    t0 = time.perf_counter()
    rows, (mesh64, lset64) = sphere_levels(dev)
    for et, nxs, err, eoc, peak in rows:
        print(f"[9 sphere] {et} nx={list(nxs)} order 4: NEG volume errors "
              + ", ".join(f"{e:.3e}" for e in err["NEG"])
              + f" (EOC {eoc['NEG']:.3f}), IF area errors "
              + ", ".join(f"{e:.3e}" for e in err["IF"])
              + f" (EOC {eoc['IF']:.3f}); NEG + POS = 1 and element_wise sums "
              f"to 1e-12; peak memory {peak:.2f} GiB", flush=True)
    lset64_32 = T.GridFunction(lset64.space, dtype=torch.float32)
    lset64_32.vec.data = lset64.vec.data
    f32_rel = {}
    for dt in ("NEG", "IF"):
        a64 = T.Integrate({"levelset": lset64, "domain_type": getattr(T, dt)},
                          1.0, mesh64, order=4)
        a32 = T.Integrate({"levelset": lset64_32, "domain_type": getattr(T, dt)},
                          1.0, mesh64, order=4)
        f32_rel[dt] = abs(a32 - a64) / a64
        check(f32_rel[dt] <= 1e-5, f"f32 vs f64 {dt} at tets nx=64: {f32_rel[dt]}")
    mesh = T.MakeStructured2DMesh(quads=False, nx=32, ny=32)
    lsetp1 = T.GridFunction(T.H1(mesh, order=1))
    T.InterpolateToP1(T.sqrt(T.x * T.x + T.y * T.y) - 0.5, lsetp1)
    area = T.Integrate({"levelset": lsetp1, "domain_type": T.NEG},
                       T.CoefficientFunction(1.0), mesh, order=4)
    check(abs(area - np.pi / 16) < 1e-3 and lsetp1.vec.data.is_cuda,
          f"Quick start area {area}")
    peaks = {"f32 vs f64 and Quick start": peak_gib(dev)}
    grad, fd = autograd_check(dev)
    peaks["autograd"] = peak_gib(dev)
    counts, nfacets = cutinfo_check(mesh64, lset64)
    peaks["CutInfo"] = peak_gib(dev)
    sphere_s = time.perf_counter() - t0
    print(f"[9 integrate] tets nx=64 ({mesh64.ne} elements): f32 vs f64 rel "
          f"NEG {f32_rel['NEG']:.3e} IF {f32_rel['IF']:.3e}; Quick start area "
          f"{area:.12f} (pi/16 = {np.pi / 16:.12f}); autograd dV/dr at r=0.31 "
          f"{grad:.10f} vs central difference {fd:.10f} (4 pi r^2 = "
          f"{4 * np.pi * 0.31 ** 2:.6f}); CutInfo NEG/POS/IF {counts} = host "
          f"count, {nfacets} facets between HASNEG and IF; peak memory GiB "
          + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items())
          + f"; wall {sphere_s:.2f} s", flush=True)

    # 10. the quadrature path of the flagship at nx=48
    t0 = time.perf_counter()
    q = quad_flagship(dev, model, struct, V)
    k, res, true64, bn = q["solve"]
    print(f"[10 quad flagship] nx={NX}: apply vs DIA operator rel f64 "
          f"{q['op_float64']:.3e} f32 {q['op_float32']:.3e}; sum(rhs) "
          f"{q['rhs_sum'][0]:.15f} vs Integrate(NEG, 1) {q['rhs_sum'][1]:.15f}; "
          f"x.rhs {q['rhs_proj'][0]:.12e} vs Integrate(NEG, u_x) "
          f"{q['rhs_proj'][1]:.12e}; solve() f32: {k} iterations, recursion "
          f"res {res:.4e} vs true f64 res {true64:.4e} (||b|| {bn:.4e}), "
          f"{q['solve_s']:.2f} s; order 2 nx=24 ({q['sym2'][0]} dofs) f32 "
          f"symmetry {q['sym2'][1]:.3e}; peak memory {peak_gib(dev):.2f} "
          f"GiB; wall {time.perf_counter() - t0:.2f} s", flush=True)

    # 11. times on the card
    t0 = time.perf_counter()
    timed = []
    for dt, gf in (("f64", lset64), ("f32", lset64_32)):
        for dom in ("NEG", "IF"):
            ld = {"levelset": gf, "domain_type": getattr(T, dom)}
            timed.append((f"Integrate {dom} order 4 tets nx=64 {dt}",
                          profiled(lambda ld=ld: T.Integrate(ld, 1.0, mesh64,
                                                             order=4))))
    timed.append(("CutInfo tets nx=64 f64",
                  profiled(lambda: T.CutInfo(mesh64, lset64))))
    timed.append((f"UnfittedPoisson.elmats nx={NX} f32", profiled(
        lambda: model.elmats(model.vertices, model.lset))))
    xa = torch.ones(model.ndof, dtype=torch.float32, device=dev)
    timed.append((f"UnfittedPoisson.apply nx={NX} f32", profiled(
        lambda: model.apply(model.vertices, model.lset, xa))))
    mv = model.operator(model.vertices, model.lset)
    timed.append((f"operator matvec alone nx={NX} f32", profiled(lambda: mv(xa))))
    timed.append((f"UnfittedPoisson.solve() nx={NX} f32", profiled(model.solve)))
    for name, (ms, nk, busy, idle, top) in timed:
        print(f"[11 times] {card()} | {name}: {ms:.3f} ms (median of 5), "
              f"{nk} device kernels, device busy {busy:.3f} ms, idle share "
              f"{idle:.3f}; top: {top}", flush=True)
    print(f"[11 times] peak memory {peak_gib(dev):.2f} GiB; wall "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 12. lattice multigrid on the DIA path (plain PyTorch: the reference has
    # no TPU kernel on it), f32 and f64, then the larger hierarchy once
    del q, mv, xa
    torch.cuda.synchronize()
    peak_gib(dev)
    t0 = time.perf_counter()
    reps = [model.assemble_vals_lattice(model.vertices, model.lset, struct)[0]
            for _ in range(5)]
    check(all(torch.equal(r, V) for r in reps),
          "assemble_vals_lattice does not repeat bit for bit")
    del reps
    kept[NX] = lattice_level(model, struct, V)
    lv32 = [kept[nx] if nx in kept else new_lattice_level(nx, dev, torch.float32)
            for nx in LMG_NX]
    lmg32 = lattice_mg(lv32, torch.float32, dev)
    again = lattice_mg(lv32, torch.float32, dev, jacobi=False)
    check(again["iters"] == lmg32["iters"] and torch.equal(again["x"], lmg32["x"]),
          "f32 MG-CG does not repeat bit for bit")
    f64 = native_f64(dev, V, b)     # phase 13, reported below
    lv64 = [new_lattice_level(nx, dev, torch.float64) for nx in LMG_NX[:-1]]
    lv64.append(lattice_level(f64["model"], f64["struct"], f64["V"]))
    lmg64 = lattice_mg(lv64, torch.float64, dev)
    lv_big = [kept[nx] if nx in kept else new_lattice_level(nx, dev, torch.float32)
              for nx in LMG_NX_BIG]
    lmg_big = lattice_mg(lv_big, torch.float32, dev)
    for r in (lmg32, lmg64, lmg_big):
        print(f"[12 lattice mg] nx={r['nxs']} {str(r['dtype'])[6:]}: coarse "
              f"inverse {r['n0']} x {r['n0']} on the device, "
              f"prepare_safe's guard passed, max|I - A0 X| {r['ainv_res']:.3e}, prepare_safe "
              f"{r['prepare_s']:.3f} s; MG-CG {r['iters']} iterations to rel "
              f"res {r['rel']:.3e}, true f64 rel res {r['true_rel']:.3e}; "
              f"Jacobi-CG {r['jacobi_iters']} iterations to rel res "
              f"{r['jacobi_rel']:.3e} (maxiter {JACOBI_MAXITER})", flush=True)
    print(f"[12 lattice mg] f32 table at nx={NX} bitwise equal over five "
          f"assemblies, MG-CG on it bitwise repeatable; peak memory "
          f"{peak_gib(dev):.2f} GiB; wall {time.perf_counter() - t0:.2f} s "
          f"(phase 13's solves included)", flush=True)

    # 13. the flagship in native f64
    print(f"[13 native f64] nx={NX}: f64 table within {f64['dv']:.3e} max|V| "
          f"of the f32 one, exactly symmetric, ncut {f64['ncut']}; f64 "
          f"Jacobi-PCG {f64['pcg_iters']} iterations, true rel res "
          f"{f64['pcg_rel']:.3e}; cg_ir true rel res {f64['ir_rel']:.3e}; "
          f"solutions differ by rel {f64['dx']:.3e}", flush=True)

    # 14. the public API, launch counters reset just before it
    dia_cg.launches = 0
    ell_spmv.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api = public_api(T, dev, f64["model"], f64["struct"], f64["V"])
    api_launches = ell_spmv.launches
    check(api_launches > 0, "the public-API path launched ell_spmv no time")
    b2_api = api["b2"]
    print(f"[14 public api] examples.fictdom3d nx={list(API_NX)} L2 errors "
          + ", ".join(f"{e:.4e}" for e in api["errs"])
          + f" (EOC {', '.join(f'{e:.3f}' for e in api['eocs'])}); nx={NX}: "
          f"{api['ntriplets']} COO triplets, ELL K={api['K']}, "
          f"{api['nfree']} free dofs, a.mat symmetric to {api['asym']:.3e}, "
          f"named direct solve (umfpack) {api['lu_s']:.2f} s (host), 'cg' "
          f"solve {api['cg_iters']} iterations = {api['cg_products']} "
          f"products = {api['cg_launches']} ell_spmv launches, direct vs "
          f"'cg' rel {api['dsol']:.3e}; default Inverse(): path "
          f"{api['default_path']}, {api['default_s']:.3f} s wall (the named "
          f"LU {api['lu_s']:.3f} s), {api['default_iters']} iterations = "
          f"{api['default_products']} products = {api['default_launches']} "
          f"ell_spmv launches, vs the named LU rel "
          f"{api['dsol_default']:.3e}; layouts built by both solves "
          f"{api['layouts']} (one table); B2 on this table "
          f"({api['nrows']} x {api['K']} f64): kernel == plain bitwise on a "
          f"seeded x and on the free-masked load (max|dy| "
          f"{b2_api['err']:.3e}), {b2_text(b2_api)}; forms operator vs "
          f"UnfittedPoisson's DIA operator on active dofs rel "
          f"{api['vs_model']:.3e}; fictdom_ghostpen nx=40 L2 "
          f"{api['fictdom_ghostpen'][0]:.10e} (CPU "
          f"{api['fictdom_ghostpen'][1]:.10e}), cutfem nx=30 L2 "
          f"{api['cutfem'][0]:.10e} (CPU {api['cutfem'][1]:.10e}); ell_spmv "
          f"launches {api_launches}, dia_cg launches {dia_cg.launches}; peak "
          f"memory {peak_gib(dev):.2f} GiB; wall "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 15. times of phases 12-14 on the card
    t0 = time.perf_counter()
    timed = []
    for r, name in ((lmg32, "f32"), (lmg_big, "f32")):
        tag = f"nx={r['nxs'][-1]} {name}"
        timed.append((f"LatticeDIAMG.prepare {tag}", profiled(
            lambda r=r: r["mg"].prepare(r["params"]))))
        mg_prof = profiled(r["mgcg"], reps=3)
        timed.append((f"MG-CG to 1e-8 {tag} ({r['iters']} iterations, "
                      f"{mg_prof[1] / r['iters']:.1f} device kernels per "
                      f"iteration)", mg_prof))
        timed.append((f"Jacobi-CG to 1e-8 {tag} ({r['jacobi_iters']} "
                      f"iterations)", profiled(r["jcg"], reps=1)))
    m64 = f64["model"]
    timed.append((f"assemble_vals_lattice nx={NX} f64", profiled(
        lambda: m64.assemble_vals_lattice(m64.vertices, m64.lset,
                                          f64["struct"]))))
    timed.append((f"f64 Jacobi-PCG nx={NX} ({f64['pcg_iters']} iterations)",
                  profiled(f64["pcg"], reps=3)))
    timed.append((f"cg_ir nx={NX} on the f64 table", profiled(f64["ir"], reps=3)))
    a_form, f_form, free = api["a"], api["f"], api["free"]
    timed.append((f"BilinearForm.Assemble fictdom3d nx={NX} f64",
                  profiled(a_form.Assemble)))
    timed.append((f"LinearForm.Assemble fictdom3d nx={NX} f64",
                  profiled(f_form.Assemble)))
    inv_cg = a_form.mat.Inverse(free, inverse="cg")
    inv_cg * f_form.vec.data   # builds the ELL view once, outside the timing
    timed.append((f"Inverse(inverse='cg') solve nx={NX} ({api['cg_iters']} "
                  f"iterations)", profiled(lambda: inv_cg * f_form.vec.data,
                                           reps=3)))
    for name, (ms, nk, busy, idle, top) in timed:
        print(f"[15 times] {card()} | {name}: {ms:.3f} ms, {nk} device "
              f"kernels, device busy {busy:.3f} ms, idle share {idle:.3f}; "
              f"top: {top}", flush=True)
    print(f"[15 times] {card()} | Inverse() direct solve nx={NX} on the host "
          f"(scipy splu, {api['nfree']} free dofs, timed in phase 14): "
          f"factorize + solve {api['lu_s']:.3f} s, solve again "
          f"{api['lu_again_s']:.3f} s | peak memory "
          f"{peak_gib(dev):.2f} GiB | wall of phase 15 "
          f"{time.perf_counter() - t0:.2f} s, of the whole run "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)

    del api, a_form, f_form, inv_cg
    sk, sk_launches = phases_16_17(T, dev, t_start)

    dia_bound_ms, dia_bound_by = dia_cg_bound(offs, model.ndof, CG_ITERS)
    print(json.dumps({"kernels": [{
        "name": "dia_cg_fused",
        "route": "cuda",
        "source": "ngsxfem_tpu_torch/csrc/dia_cg.cu",
        "replaces": "ngsxfem_tpu/solvers/pallas_cg.py:159",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": pcg_ms,
        "plain_ms": plain_ms,
        "bound_ms": dia_bound_ms,
        "bound_by": dia_bound_by,
        "library_ms": None,
    }, {
        "name": "ell_spmv",
        "route": "cuda",
        "source": "ngsxfem_tpu_torch/csrc/ell_spmv.cu",
        "replaces": "ngsxfem_tpu/solvers/sparse.py:179",
        "launches": ell_launches,
        "max_abs_err": ell_err,
        "ms": b2_48["ms"],
        "device_us": b2_48["dev_us"],
        "before_us": b2_48["before_us"],
        "plain_ms": b2_48["plain_ms"],
        "plain_ell_ms": b2_48["plain_ell_ms"],
        "bound_ms": b2_48["bound"][0],
        "bound_by": b2_48["bound"][1],
        "bound_nnz_ms": b2_48["bound"][0],
        "bound_padded_ms": b2_48["bound_padded"][0],
        "slice_fill": b2_48["fill"],
        "library_ms": b2_48["lib_ms"],
        "launches_public_api": api_launches,
        "public_api_table": b2_record(b2_api),
        "launches_slice6": sk_launches,
        "slice6_tables": [dict(b2_record(b["b2"]), launches=b["launches"])
                          for b in sk["bigs"]],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
