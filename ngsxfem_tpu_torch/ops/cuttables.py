"""Sign-pattern decomposition of a cut reference simplex (host, numpy).

Copied from ``ngsxfem_tpu/ops/cuttables.py`` (the part the closed-form P1
kernel needs).  A d-simplex has only 2^(d+1) vertex sign patterns, each with
a bounded number of sub-simplices, so the decomposition is a static table
unrolled into the assembly program (the batched analog of the reference's
``LevelsetCutSimplex::Decompose``, cutint/straightcutrule.cpp:131-204).

Vertex spec encoding: a pair (a, b) of local vertex indices.
  a == b  -> the original vertex a
  a != b  -> the point on edge (a,b) where the P1 level set changes sign,
             i.e. (1-t)*V_a + t*V_b with t = phi_a / (phi_a - phi_b).
"""
from __future__ import annotations

import numpy as np


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
