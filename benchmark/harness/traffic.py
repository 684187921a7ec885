"""The one generator of the benchmark's traffic.

A cell's traffic file (``workloads/<cell>.json``) holds parameters only:

- ``walk``: ``{"step_h": s, "box": b}`` moves the sphere's centre each
  step along one path, the same for every seed and never returning to a
  position: the curve ``c0 + b (sin t, sin(sqrt(2) t), sin(sqrt(3) t))``
  from ``t = 0`` (``c0`` the configuration's centre), in chords of ``s``
  mesh widths.  Its frequencies have irrational ratios, so it covers the
  box ``|c_i - c0_i| <= b`` without closing; a window of some tens of
  steps of ``h/4`` reaches the box's faces in each coordinate.  The solver's
  work depends on the geometry (Jacobi-CG needs 104-445 iterations at
  different positions), so every seed walks the same positions in the same
  order, and the seed picks only the load, the steps the comparison judges
  and its probe; ``null`` keeps the sphere at ``c0``;
- ``load``: ``{"a0": [lo, hi], "a": [lo, hi]}`` draws a new load ``f = a0 +
  a.x`` each step, ``a0`` and the three entries of ``a`` uniform in their
  ranges; ``null`` keeps the configuration's load;
- ``sample``: how many of the window's steps the comparison judges, drawn
  from the seed;
- ``trace_steps``: how many steps the profiler records in a traced run;
- ``limits``: the limit of each number the comparison computes.

Every seed gets the same positions, and loads of the same distribution.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Step:
    index: int
    centre: tuple
    load: tuple  # (a0, (a_x, a_y, a_z))


def _rng(seed, stream):
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed) % 2 ** 64, stream])))


class Generator:
    """Step inputs of one run, from the cell's traffic and the seed."""

    def __init__(self, traffic, sizes, seed):
        self.load = traffic.get("load")
        self.default_load = (float(sizes["load"][0]),
                             tuple(float(v) for v in sizes["load"][1]))
        self.rng = _rng(seed, 0)
        c0 = tuple(float(v) for v in sizes["centre"])
        self.path = iter(_curve(traffic["walk"], sizes)
                         if traffic.get("walk") else [])
        self.c0 = c0
        self.k = 0

    def __next__(self):
        centre = next(self.path, self.c0)
        if self.load:
            a0 = float(self.rng.uniform(*self.load["a0"]))
            a = tuple(float(v) for v in self.rng.uniform(*self.load["a"], 3))
            load = (a0, a)
        else:
            load = self.default_load
        step = Step(self.k, centre, load)
        self.k += 1
        return step

    def __iter__(self):
        return self


FREQUENCIES = (1.0, math.sqrt(2.0), math.sqrt(3.0))


def _curve(walk, sizes):
    """The positions of a walk, endless: points of the curve ``c(t) = c0 +
    b sin(w t)`` from ``t = 0``, each a chord of ``step_h`` mesh widths from
    the one before (found by marching ``t`` and one bisection)."""
    lo, hi = sizes["box"]
    step = walk["step_h"] * (hi - lo) / sizes["nx"]
    c0 = [float(v) for v in sizes["centre"]]
    b = float(walk["box"])

    def at(t):
        return [c + b * math.sin(w * t) for c, w in zip(c0, FREQUENCIES)]

    # |c'| <= b |w|, so a march in t of dt moves the centre at most step / 8
    dt = step / (8.0 * b * math.hypot(*FREQUENCIES))
    t, c = 0.0, at(0.0)
    while True:
        yield tuple(c)
        t1 = t + dt
        while math.dist(at(t1), c) < step:
            t, t1 = t1, t1 + dt
        lo_t, hi_t = t, t1
        for _ in range(40):
            mid = 0.5 * (lo_t + hi_t)
            if math.dist(at(mid), c) < step:
                lo_t = mid
            else:
                hi_t = mid
        t = hi_t
        c = at(t)


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from the seed (holds references only)."""

    def __init__(self, k, seed):
        self.k = k
        self.items = []
        self.seen = 0
        self.rng = random.Random(int(seed) % 2 ** 64 + 1)

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1
