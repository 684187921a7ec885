"""Uniform simplex subdivision tables for the ``subdivlvl > 0`` quadrature.

Counterpart of ``ngsxfem_tpu/ops/subdivide.py`` (host numpy, copied): where
the reference's legacy adaptive engine (``cutint/xintegration.cpp:698+``,
``NumericalIntegrationStrategy::MakeQuadRule``) recursively bisects an
element whose level set is a genuine CoefficientFunction, these tables hold
a uniform dyadic subdivision of the reference element into
``O(2^(d*lvl))`` sub-simplices.  The level set is evaluated once at the
deduplicated subdivision lattice of every element and the batched
straight-cut rule (``ops/straightcut.cut_rule_simplices``) runs over the
sub-simplices; ``integrate.subdiv_tiers`` prunes the uncut ones at depths
0 and 1, as the reference does (``Simplex::CheckIfCut``,
cutint/xdecompose.hpp:34-87).  Each level shrinks the geometry error of
the piecewise-linear interface by ~4x.

Tensor-product elements (QUAD/HEX) are first split into 2/6 simplices
(``ET_SPLIT``) and each split simplex subdivided, the analog of the
reference's ``DecomposePrismIntoSimplices`` (cutint/xdecompose.hpp:131-149).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from .cuttables import ET_SPLIT, REF_VERTS
from .gauss import ET_DIM


def _red_refine(sub):
    """Red-refine one d-simplex given by integer vertex rows (nv, d)."""
    d = sub.shape[0] - 1
    v = sub
    if d == 1:
        m = (v[0] + v[1]) // 2
        return [np.stack([v[0], m]), np.stack([m, v[1]])]
    if d == 2:
        m01 = (v[0] + v[1]) // 2
        m12 = (v[1] + v[2]) // 2
        m02 = (v[0] + v[2]) // 2
        return [
            np.stack([v[0], m01, m02]),
            np.stack([m01, v[1], m12]),
            np.stack([m02, m12, v[2]]),
            np.stack([m01, m12, m02]),
        ]
    if d == 3:
        m01 = (v[0] + v[1]) // 2
        m02 = (v[0] + v[2]) // 2
        m03 = (v[0] + v[3]) // 2
        m12 = (v[1] + v[2]) // 2
        m13 = (v[1] + v[3]) // 2
        m23 = (v[2] + v[3]) // 2
        # 4 corner tets + the central octahedron split along the m01-m23
        # diagonal (Bey red refinement; any diagonal is volume-exact)
        return [
            np.stack([v[0], m01, m02, m03]),
            np.stack([m01, v[1], m12, m13]),
            np.stack([m02, m12, v[2], m23]),
            np.stack([m03, m13, m23, v[3]]),
            np.stack([m01, m23, m02, m03]),
            np.stack([m01, m23, m03, m13]),
            np.stack([m01, m23, m13, m12]),
            np.stack([m01, m23, m12, m02]),
        ]
    raise NotImplementedError(f"subdivision for d={d}")


@lru_cache(maxsize=None)
def subdivision_tables(et: str, lvl: int):
    """Host tables (lattice (nlat, d) float64, subs (nsub, d+1) int32).

    ``lattice`` holds the deduplicated vertex coordinates of the level-
    ``lvl`` dyadic subdivision of the reference element ``et``; ``subs``
    indexes the sub-simplex vertices into it.  The coordinates are exact
    dyadic rationals (built on an integer lattice scaled by 2^lvl, so the
    deduplication is exact).  The descendants are built depth first: those
    of depth-1 child ``c`` are rows ``[c*g, (c+1)*g)``.
    """
    if lvl < 0:
        raise ValueError("subdivlvl must be >= 0")
    d = ET_DIM[et]
    scale = 1 << lvl
    refv = REF_VERTS[et]

    sub_list = []
    for s in ET_SPLIT[et]:
        # split-simplex vertices on the integer lattice (REF_VERTS are 0/1)
        work = [np.asarray(np.rint(refv[s] * scale), dtype=np.int64)]
        for _ in range(lvl):
            work = [t for w in work for t in _red_refine(w)]
        sub_list.extend(work)

    key2id: dict[tuple, int] = {}
    lattice = []
    subs = np.empty((len(sub_list), d + 1), dtype=np.int32)
    for i, simplex in enumerate(sub_list):
        for j, vtx in enumerate(simplex):
            k = tuple(int(c) for c in vtx)
            idx = key2id.get(k)
            if idx is None:
                idx = len(lattice)
                key2id[k] = idx
                lattice.append(vtx)
            subs[i, j] = idx
    return np.asarray(lattice, dtype=np.float64) / float(scale), subs


@lru_cache(maxsize=None)
def child_tables(et: str, lvl: int):
    """Host tables of the depth-1 prune of the banded ``subdivlvl`` path:
    ``(lattice, subs, child_pts (nchild, L) int32, the lattice points of
    each depth-1 child padded with its last one, nchild, g)``, where the
    descendants of child ``c`` are rows ``[c*g, (c+1)*g)`` of ``subs``
    (``subdivision_tables`` builds them depth first, in the order of
    ``subdivision_tables(et, 1)``'s children)."""
    lattice, subs = subdivision_tables(et, lvl)
    nchild = subdivision_tables(et, 1)[1].shape[0]
    nsub = subs.shape[0]
    assert nsub % nchild == 0, (nsub, nchild)
    g = nsub // nchild
    sets = [np.unique(subs[c * g:(c + 1) * g]) for c in range(nchild)]
    L = max(len(s) for s in sets)
    child_pts = np.stack([np.pad(s, (0, L - len(s)), mode="edge")
                          for s in sets]).astype(np.int32)
    return lattice, subs, child_pts, nchild, g
