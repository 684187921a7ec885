#!/usr/bin/env python3
"""Time a ``SparseMatrix``'s ELL conversion on the host against the card's.

    python3 tools/torch_to_ell_before_after.py [--nx 48] [--reps 20]

Run from the repository root on a machine with one CUDA card and ``nvcc``.
It builds ``a.mat`` of ``examples.fictdom3d`` (the benchmark's
``fictdom3d-p1-forms`` at the fixed sphere) at ``--nx`` on the card, then
converts it to the padded ``(n, K)`` ELL table in two ways, in turns
(host, card, card, host, ...):

- ``host``: the triplets copied to the host, ``SparseMatrix.to_ell`` there
  (``coo_ell.coo_to_ell`` with its plain step, ``place_plain``), the table
  copied back;
- ``card``: ``SparseMatrix.to_ell`` on the card, ``coo_ell.coo_to_ell``:
  one stable sort, two host reads and the kernel ``csrc/coo_ell.cu``.

For each: the median over ``--reps`` calls of the time between two CUDA
events around the call (``event_ms``) and of the host clock from the call
to a synchronise after it (``host_ms``); from one profiled call the
device's busy time (``device_ms``), its operations, and the host syncs in
the span ``SparseMatrix::to_ell`` (the program's ``host_syncs`` counter).  Then the
kernel's own device time beside its bound (bytes it must move over
3.35 TB/s), the plain version of the kernel's step (``place_plain``) on the
card, and ``torch.sparse_coo_tensor(...).coalesce()`` (the dedup and sum
alone, no placement) as a yardstick.  The card's table must equal the host's
bit for bit (columns and the bits of the values); the script exits 1 where
it does not.  Prints one line per measurement and a JSON line at the end,
with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAN = "SparseMatrix::to_ell"
KERNEL = "coo_ell_place_kernel"
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s


def card_info():
    import torch

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = "nvidia-smi not available"
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": out}


def timed(fn, reps):
    """Medians over ``reps`` calls: (event ms, host ms, last result)."""
    import torch

    ev, host = [], []
    out = None
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
        ev.append(a.elapsed_time(b))
    return statistics.median(ev), statistics.median(host), out


def profiled(fn):
    """One call under torch.profiler: device busy ms, {op: ms}, the number
    of device operations, and the host syncs counted in the span
    ``SparseMatrix::to_ell``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ngsxfem_tpu_torch.utils import timing

    timing.reset_trace()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    syncs = sum(r["counters"].get(timing.SYNC_COUNTER, 0)
                for r in timing.spans() if r["name"] == SPAN)
    timing.reset_trace()
    ivs, ops = [], {}
    for e in prof.events():
        # a span's annotation also has a device range, over its kernels
        if e.device_type != DeviceType.CUDA or e.name == SPAN:
            continue
        s, t = e.time_range.start, e.time_range.end
        ivs.append((s, t))
        ops[e.name] = ops.get(e.name, 0.0) + 1e-3 * (t - s)
    busy, end = 0.0, None
    for s, t in sorted(ivs):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return 1e-3 * busy, ops, len(ivs), syncs


def kernel_bytes(T, nu, n, val_bytes):
    """Bytes the kernel must move: per triplet its position and its value
    (gathered), per unique entry its run start, key, first position and
    its slot of the table written, the row pointers once."""
    return (8 + val_bytes) * T + (8 * 3 + 4 + val_bytes) * nu + 8 + \
        8 * (n + 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=48)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_to_ell_before_after: no CUDA card", file=sys.stderr)
        return 2
    from ngsxfem_tpu_torch.examples import fictdom3d
    from ngsxfem_tpu_torch.solvers import coo_ell, sparse

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    a = fictdom3d.system(nx=args.nx, device=dev)[0]
    a.Assemble()
    S = a.mat
    T = S.vals.shape[0]

    def host():
        E = sparse.SparseMatrix(S.rows.cpu(), S.cols.cpu(), S.vals.cpu(),
                                S.shape, device="cpu").to_ell()
        return sparse.ELLMatrix(E.cols.to(dev), E.vals.to(dev), S.shape)

    def card():
        return S.to_ell()

    card()  # builds the kernel
    host()
    torch.cuda.synchronize()
    res = {"nx": args.nx, "n": S.shape[0], "triplets": T, **card_info()}
    ev = {"host": [], "card": []}
    hs = {"host": [], "card": []}
    tables = {}
    for i in range(args.reps):
        order = ("host", "card") if i % 2 == 0 else ("card", "host")
        for name in order:
            e, h, tables[name] = timed(host if name == "host" else card, 1)
            ev[name].append(e)
            hs[name].append(h)
    hE, cE = tables["host"], tables["card"]
    bits = {torch.float64: torch.int64, torch.float32: torch.int32}[
        cE.vals.dtype]
    equal = (hE.cols.shape == cE.cols.shape
             and torch.equal(hE.cols, cE.cols)
             and torch.equal(hE.vals.view(bits), cE.vals.view(bits)))
    n, K = cE.cols.shape
    nu = torch.unique(S.rows.long() * S.shape[1] + S.cols.long()).numel()
    res.update({"K": K, "equal": bool(equal)})
    for name, fn in (("host", host), ("card", card)):
        busy, ops, n_ops, syncs = profiled(fn)
        res[name] = {"event_ms": statistics.median(ev[name]),
                     "host_ms": statistics.median(hs[name]),
                     "event_ms_quartiles": statistics.quantiles(ev[name], n=4),
                     "device_ms": busy, "syncs": syncs,
                     "device_ops": n_ops,
                     "top_ops_ms": dict(sorted(ops.items(),
                                               key=lambda kv: -kv[1])[:6])}
        if name == "card":
            res["kernel_us"] = 1e3 * sum(v for k, v in ops.items()
                                         if KERNEL in k)
    vb = cE.vals.element_size()
    res["kernel_bound_us"] = 1e6 * kernel_bytes(T, nu, n, vb) / HBM_BPS
    res["path_bound_us"] = 1e6 * ((8 + vb) * T + (4 + vb) * n * K) / HBM_BPS
    res["entries"] = nu

    place = coo_ell._place_kernel
    coo_ell._place_kernel = coo_ell.place_plain
    try:
        pe, _, pE = timed(card, 5)
    finally:
        coo_ell._place_kernel = place
    res["plain_on_card_event_ms"] = pe
    res["plain_equal"] = bool(torch.equal(pE.cols, cE.cols) and torch.equal(
        pE.vals.view(bits), cE.vals.view(bits)))
    idx = torch.stack([S.rows.long(), S.cols.long()])
    le, _, _ = timed(lambda: torch.sparse_coo_tensor(
        idx, S.vals, S.shape).coalesce(), 5)
    res["library_coalesce_event_ms"] = le

    for name in ("host", "card"):
        r = res[name]
        print(f"{name}: {r['event_ms']:.3f} ms (events, median of "
              f"{args.reps}), host {r['host_ms']:.3f} ms, device "
              f"{r['device_ms']:.3f} ms in {r['device_ops']} ops, "
              f"{r['syncs']} syncs in the span")
    print(f"kernel {res['kernel_us']:.3f} us, bound {res['kernel_bound_us']:.3f}"
          f" us; path bound {res['path_bound_us']:.3f} us; plain on the card "
          f"{pe:.3f} ms; coalesce {le:.3f} ms; equal {equal}")
    print(json.dumps(res), flush=True)
    return 0 if equal and res["plain_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
