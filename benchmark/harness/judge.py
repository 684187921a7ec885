"""The comparison that decides ``correct``.

A configuration's driver turns the program's outputs of a sampled step
into a canonical form, in the plain reference's numbering (vertex ``(i, j,
k)`` of the lattice, the reference's element order), without computing
anything the reference computes:

- ``hasneg``, ``cut``: element masks; or ``ncut``, the number of cut
  elements, where the program gives no masks;
- ``active``: the vertex mask the program solves on;
- ``matvec``: ``x -> A x`` of the program's operator, read from its
  table (float64);
- ``rhs``, ``sol``: the program's load and solution (float64).

``numbers`` compares them with the reference system of the same inputs;
every number is 0 for an exact match.
"""
from __future__ import annotations

import torch


def rel_max(a, b):
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def numbers(canon, system, sol, probe):
    """{name: value} of one sampled step: ``geom`` elements whose masks
    differ (or the difference of the cut counts), ``active`` vertices whose
    mark differs, ``op`` the relative gap of the operators' products with
    ``probe``, ``load`` of the loads, ``sol`` of the solutions."""
    out = {}
    if "hasneg" in canon:
        out["geom"] = int((canon["hasneg"] != system.hasneg).sum()
                          + (canon["cut"] != system.cut).sum())
    else:
        out["geom"] = abs(int(canon["ncut"]) - int(system.cut.sum()))
    out["active"] = int((canon["active"] != system.active).sum())
    out["op"] = rel_max(canon["matvec"](probe), system.matvec(probe))
    if "rhs" in canon:
        out["load"] = rel_max(canon["rhs"], system.rhs)
    out["sol"] = rel_max(canon["sol"], sol)
    return out


def worst(readings):
    """The largest value of each number over the sampled steps."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def verdict(values, limits):
    """(all within their limits, {name: [value, limit]}); a number without
    a limit fails."""
    table = {k: [v, limits.get(k)] for k, v in values.items()}
    ok = all(lim is not None and v <= lim for v, lim in table.values())
    return ok, table


def dia_product(offsets, V, x):
    """y[r] = sum_k V[k, r] x[r + o_k], reading zero beyond either end: the
    product of an offset-diagonal table, for judging it."""
    n = x.shape[0]
    y = torch.zeros(n, dtype=torch.float64, device=x.device)
    for k, o in enumerate(int(o) for o in offsets):
        lo, hi = max(0, -o), min(n, n - o)
        y[lo:hi] += V[k, lo:hi].to(torch.float64) * x[lo + o:hi + o]
    return y
