#!/usr/bin/env python3
"""Time the port's fixed-order assembly beside the atomic one it replaced.

    git archive d41764a ngsxfem_tpu_torch native | tar -x -C build/parent
    python3 tools/torch_assembly_before_after.py build/parent [--turns 2]

Run from the repository root on a machine with one CUDA card.  PARENT_DIR
holds an older copy of the ``ngsxfem_tpu_torch`` package and, beside it,
the ``native/`` sources its dof numbering is built from (without them it
falls back to numpy's numbering, and its vectors cannot be compared).  As
of commit d41764a its ``assemble_vals_soa1`` and ``LinearForm.Assemble``
add with ``index_add_``, atomic on the card.  It is imported beside the
current package under the name ``ngsxfem_tpu_torch_parent``, in the same
process.
Both assemble, on the card:

- ``UnfittedPoisson.assemble_vals_soa1`` of the flagship's ELL table (3D
  P1, nx=48, f32; the current one adds its three streams through a
  ``ScatterPlan`` cached per structure);
- ``LinearForm.Assemble`` of ``examples.fictdom3d``'s load at nx=48 (f64;
  the current one keeps its ``ScatterPlan`` for the next call).

They run in turns (parent, current, current, parent, ``--turns`` times).
Each gives its first call's ms (the current one builds its plan there), the
median ms of ``--reps`` calls after it by CUDA events, and the device busy
ms of one call (``torch.profiler``, the sum of its kernels).  Checks: the
current tables and vectors bitwise equal over the repeated calls, and equal
to the parent's to 1e-6 (f32) and 1e-12 (f64) relative.  Prints one line
per case and one JSON line, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_parent(parent_dir):
    """The package under ``parent_dir/ngsxfem_tpu_torch``, imported as
    ``ngsxfem_tpu_torch_parent`` (its modules import each other relatively)."""
    pkg = os.path.join(os.path.abspath(parent_dir), "ngsxfem_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "ngsxfem_tpu_torch_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_fictdom3d(T, nx, device):
    """``examples.fictdom3d``'s LinearForm at ``nx``, written with the
    package ``T``."""
    mesh = T.MakeStructured3DMesh(
        hexes=False, nx=nx, ny=nx, nz=nx,
        mapping=lambda a, b, c: (2 * a - 1, 2 * b - 1, 2 * c - 1))
    lsetp1 = T.GridFunction(T.H1(mesh, order=1, device=device))
    T.InterpolateToP1(T.sqrt(T.x * T.x + T.y * T.y + T.z * T.z) - 0.7, lsetp1)
    hasneg = T.CutInfo(mesh, lsetp1).GetElementsOfType(T.HASNEG)
    Vh = T.H1(mesh, order=1, dgjumps=True, device=device)
    _, v = Vh.TnT()
    f = T.LinearForm(Vh)
    f += T.SymbolicLFI({"levelset": lsetp1, "domain_type": T.NEG},
                       form=T.CoefficientFunction(6.0) * v,
                       definedonelements=hasneg)
    return f


def event_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def busy_ms(fn):
    """Device busy ms of one call: the sum of its kernels' device times."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        us += getattr(evt, "device_time_total",
                      getattr(evt, "cuda_time_total", 0)) or 0
    return us / 1e3


def measure(fn, reps):
    """(result of the first call, first ms, median ms of reps, busy ms,
    every result)."""
    torch.cuda.synchronize()
    out, first = event_ms(fn)
    outs, ts = [], []
    for _ in range(reps):
        o, t = event_ms(fn)
        outs.append(o)
        ts.append(t)
    return out, first, statistics.median(ts), busy_ms(fn), outs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent_dir")
    ap.add_argument("--nx", type=int, default=48)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import ngsxfem_tpu_torch as cur

    pkgs = {"parent": load_parent(args.parent_dir), "current": cur}
    dev = torch.device("cuda")
    cases = {}
    for who, T in pkgs.items():
        pois = importlib.import_module(T.__name__ + ".models.poisson")
        m = pois.UnfittedPoisson(nx=args.nx, dim=3, order=1,
                                 dtype=torch.float32, device=dev)
        st = m.ell_structure()
        f = load_fictdom3d(T, args.nx, dev)
        cases[who] = {
            "assemble_vals_soa1": (lambda m=m, st=st: m.assemble_vals_soa1(
                m.vertices, m.lset, st)[0]),
            "LinearForm.Assemble": (lambda f=f: f.Assemble().vec.data),
        }
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rec = {name: {"parent": [], "current": []}
           for name in cases["current"]}
    first_out = {}
    t0 = time.perf_counter()
    for turn in range(args.turns):
        for who in ("parent", "current", "current", "parent"):
            for name, fn in cases[who].items():
                out, first, med, busy, outs = measure(fn, args.reps)
                rec[name][who].append({"first_ms": first, "ms": med,
                                       "busy_ms": busy})
                ref = first_out.setdefault((name, who), out)
                if who == "current" and not all(
                        torch.equal(o, ref) for o in [out] + outs):
                    raise RuntimeError(f"{name}: two current results "
                                       f"differ")
    for name in rec:
        a, b = first_out[(name, "parent")], first_out[(name, "current")]
        rel = float(torch.linalg.vector_norm((a - b).reshape(-1).double())
                    / torch.linalg.vector_norm(a.reshape(-1).double()))
        tol = 1e-6 if a.dtype == torch.float32 else 1e-12
        if not rel <= tol:
            raise RuntimeError(f"{name}: current vs parent rel {rel}")
        rec[name]["rel_vs_parent"] = rel
        for who in ("parent", "current"):
            r = rec[name][who]
            print(f"{name} nx={args.nx} {who}: ms "
                  f"{[round(x['ms'], 4) for x in r]}, first call "
                  f"{[round(x['first_ms'], 4) for x in r]}, device busy "
                  f"{[round(x['busy_ms'], 4) for x in r]}", flush=True)
        print(f"{name}: current vs parent rel {rel:.3e}", flush=True)
    print(f"card: {card}; wall {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"card": card, "nx": args.nx, "cases": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
