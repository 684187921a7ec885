"""Sign-pattern decomposition of a cut reference simplex (host, numpy).

Copied from ``ngsxfem_tpu/ops/cuttables.py``.  A d-simplex has only
2^(d+1) vertex sign patterns, each with a bounded number of sub-simplices,
so the decomposition is a static table: cutting a batch of simplices is a
pattern id per simplex, a gather of table rows and an interpolation of edge
cut points (the batched analog of the reference's
``LevelsetCutSimplex::Decompose``, cutint/straightcutrule.cpp:131-204).

Vertex spec encoding: a pair (a, b) of local vertex indices.
  a == b  -> the original vertex a
  a != b  -> the point on edge (a,b) where the P1 level set changes sign,
             i.e. (1-t)*V_a + t*V_b with t = phi_a / (phi_a - phi_b).

Degenerate (padding) sub-simplices repeat vertex (0,0) so their volume factor
vanishes; interface padding rows are masked explicitly via ``imask``.

Per-dimension capacities (tight):
  d=1: 2 sub-segments, 1 interface point
  d=2: 3 sub-triangles, 1 interface segment
  d=3: 6 sub-tets, 2 interface triangles
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

NSUB = {1: 2, 2: 3, 3: 6}
NIF = {1: 1, 2: 1, 3: 2}


def _pattern_groups(p: int, nv: int):
    """Split local vertices into (negs, poss) for sign pattern p (bit i = vertex i POS)."""
    negs = [i for i in range(nv) if not (p >> i) & 1]
    poss = [i for i in range(nv) if (p >> i) & 1]
    return negs, poss


def _decompose(d: int, p: int):
    """Return (subs, sides, ifs) for pattern p on the reference d-simplex.

    subs: list of (d+1)-tuples of vertex specs; sides: 0=NEG / 1=POS per sub;
    ifs: list of d-tuples of vertex specs (the (d-1)-dim interface simplices).
    """
    nv = d + 1
    negs, poss = _pattern_groups(p, nv)
    V = lambda a: (a, a)
    E = lambda a, b: (a, b)

    if not negs or not poss:  # uncut
        side = 1 if not negs else 0
        return [tuple(V(i) for i in range(nv))], [side], []

    if d == 1:
        a, b = negs[0], poss[0]
        subs = [(V(a), E(a, b)), (E(a, b), V(b))]
        sides = [0, 1]
        ifs = [(E(a, b),)]
        return subs, sides, ifs

    if d == 2:
        if len(negs) == 1:
            L, (A, B), sL = negs[0], poss, 0
        else:
            L, (A, B), sL = poss[0], negs, 1
        sO = 1 - sL
        subs = [
            (V(L), E(L, A), E(L, B)),
            (E(L, A), V(A), V(B)),
            (E(L, A), V(B), E(L, B)),
        ]
        sides = [sL, sO, sO]
        ifs = [(E(L, A), E(L, B))]
        return subs, sides, ifs

    if d == 3:
        if len(negs) == 1 or len(poss) == 1:
            # 1-3 split: lone vertex L vs triangle (A,B,C)
            if len(negs) == 1:
                L, (A, B, C), sL = negs[0], poss, 0
            else:
                L, (A, B, C), sL = poss[0], negs, 1
            sO = 1 - sL
            PA, PB, PC = E(L, A), E(L, B), E(L, C)
            subs = [
                (V(L), PA, PB, PC),
                # staircase split of the prism (PA,PB,PC | A,B,C)
                (PA, PB, PC, V(A)),
                (PB, PC, V(A), V(B)),
                (PC, V(A), V(B), V(C)),
            ]
            sides = [sL, sO, sO, sO]
            ifs = [(PA, PB, PC)]
            return subs, sides, ifs
        else:
            # 2-2 split: NEG edge (A,B) vs POS edge (C,D)
            (A, B), (C, D) = negs, poss
            PAC, PAD = E(A, C), E(A, D)
            PBC, PBD = E(B, C), E(B, D)
            subs = [
                # NEG wedge, staircase over bottom (A,PAC,PAD) / top (B,PBC,PBD)
                (V(A), PAC, PAD, V(B)),
                (PAC, PAD, V(B), PBC),
                (PAD, V(B), PBC, PBD),
                # POS wedge, staircase over bottom (C,PAC,PBC) / top (D,PAD,PBD)
                (V(C), PAC, PBC, V(D)),
                (PAC, PBC, V(D), PAD),
                (PBC, V(D), PAD, PBD),
            ]
            sides = [0, 0, 0, 1, 1, 1]
            # interface quad (PAC,PBC,PBD,PAD), split into two triangles
            ifs = [(PAC, PBC, PBD), (PAC, PBD, PAD)]
            return subs, sides, ifs

    raise ValueError(f"unsupported simplex dimension {d}")


@lru_cache(maxsize=None)
def simplex_cut_tables(d: int):
    """Dense case tables for the reference d-simplex.

    Returns dict with int8 numpy arrays:
      vtab  (2^(d+1), NSUB, d+1, 2)  sub-simplex vertex specs
      stab  (2^(d+1), NSUB)          side of each sub-simplex (0 NEG / 1 POS)
      smask (2^(d+1), NSUB)          1 where the sub-simplex is real
      itab  (2^(d+1), NIF, d, 2)     interface simplex vertex specs
      imask (2^(d+1), NIF)           1 where the interface simplex is real
    """
    nv = d + 1
    npat = 2**nv
    nsub, nif = NSUB[d], NIF[d]
    vtab = np.zeros((npat, nsub, nv, 2), dtype=np.int8)
    stab = np.zeros((npat, nsub), dtype=np.int8)
    smask = np.zeros((npat, nsub), dtype=np.int8)
    itab = np.zeros((npat, nif, d, 2), dtype=np.int8)
    imask = np.zeros((npat, nif), dtype=np.int8)
    for p in range(npat):
        subs, sides, ifs = _decompose(d, p)
        for k, (sub, side) in enumerate(zip(subs, sides)):
            vtab[p, k] = np.array(sub, dtype=np.int8)
            stab[p, k] = side
            smask[p, k] = 1
        for k, f in enumerate(ifs):
            itab[p, k] = np.array(f, dtype=np.int8)
            imask[p, k] = 1
    return {"vtab": vtab, "stab": stab, "smask": smask, "itab": itab, "imask": imask}


# --- splits of tensor-product elements into simplices --------------------
# QUAD vertices (0,0),(1,0),(1,1),(0,1); HEX vertices in the standard order
# (0,0,0),(1,0,0),(1,1,0),(0,1,0),(0,0,1),(1,0,1),(1,1,1),(0,1,1).
# The HEX split is the 6-tet Kuhn triangulation (all tets share the main
# diagonal 0-6), matching the fallback route of the reference
# (``cutint/straightcutrule.cpp:475-491`` GetFallbackIntegrationRule).

QUAD_SPLIT = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32)
HEX_SPLIT = np.array(
    [
        [0, 1, 2, 6],
        [0, 1, 5, 6],
        [0, 3, 2, 6],
        [0, 3, 7, 6],
        [0, 4, 5, 6],
        [0, 4, 7, 6],
    ],
    dtype=np.int32,
)

# reference-element vertex coordinates
REF_VERTS = {
    "segm": np.array([[0.0], [1.0]]),
    "trig": np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
    "quad": np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]),
    "tet": np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=np.float64),
    "hex": np.array(
        [
            [0, 0, 0],
            [1, 0, 0],
            [1, 1, 0],
            [0, 1, 0],
            [0, 0, 1],
            [1, 0, 1],
            [1, 1, 1],
            [0, 1, 1],
        ],
        dtype=np.float64,
    ),
}

# how each element type decomposes into simplices (identity for simplices)
ET_SPLIT = {
    "segm": np.array([[0, 1]], dtype=np.int32),
    "trig": np.array([[0, 1, 2]], dtype=np.int32),
    "quad": QUAD_SPLIT,
    "tet": np.array([[0, 1, 2, 3]], dtype=np.int32),
    "hex": HEX_SPLIT,
}
