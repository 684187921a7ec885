"""Element-local node bookkeeping (the part of ``ngsxfem_tpu/integrate.py``
the flagship needs)."""
from __future__ import annotations

import numpy as np

from .fem.basis import lagrange_element


def vertex_local_ids(et: str, order: int):
    """Indices of the Lagrange nodes sitting at the element vertices, in
    REF_VERTS order (local node layout is lexicographic, not vertex-major)."""
    from .ops.cuttables import REF_VERTS

    nodes = lagrange_element(et, order)["nodes"]
    refv = REF_VERTS[et]
    ids = []
    for v in refv:
        d = np.linalg.norm(nodes - v[None, :], axis=1)
        j = int(np.argmin(d))
        assert d[j] < 1e-12, "vertex node missing"
        ids.append(j)
    return np.array(ids, dtype=np.int32)
