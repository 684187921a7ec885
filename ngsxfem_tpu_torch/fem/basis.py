"""Nodal Lagrange bases (host tables).

Counterpart of ``ngsxfem_tpu/fem/basis.py:27,116``: the monomial-coefficient
matrix per (element type, order), ``shape_i(p) = sum_m mono_m(p) * C[m, i]``,
with classical equispaced Lagrange nodes.
"""
from __future__ import annotations

from functools import lru_cache
from itertools import product

import numpy as np

from ..ops.gauss import ET_DIM


@lru_cache(maxsize=None)
def lagrange_element(et: str, order: int):
    """Nodes, monomial exponents and coefficient matrix for (et, order).

    Returns dict of numpy arrays:
      nodes (nd, d)   reference coordinates of the Lagrange nodes
      exps  (nm, d)   monomial exponents
      coeff (nm, nd)  coefficients: shapes(p) = mono(p) @ coeff
    """
    d = ET_DIM[et]
    k = int(order)
    if k < 0:
        raise ValueError("order must be >= 0")
    if k == 0:
        # piecewise constants (L2 only): single node at centroid
        cent = {"segm": [0.5], "trig": [1 / 3, 1 / 3], "quad": [0.5, 0.5],
                "tet": [0.25, 0.25, 0.25], "hex": [0.5, 0.5, 0.5]}[et]
        return {
            "nodes": np.array([cent], dtype=np.float64),
            "exps": np.zeros((1, d), dtype=np.int64),
            "coeff": np.ones((1, 1), dtype=np.float64),
        }

    simplex = et in ("segm", "trig", "tet")
    rng = range(k + 1)
    if simplex:
        tuples = [t for t in product(rng, repeat=d) if sum(t) <= k]
    else:
        tuples = list(product(rng, repeat=d))
    exps = np.array(tuples, dtype=np.int64)
    nodes = exps.astype(np.float64) / k
    # Vandermonde V[i, m] = mono_m(node_i)
    V = np.prod(nodes[:, None, :] ** exps[None, :, :], axis=-1)
    coeff = np.linalg.inv(V)  # (nm, nd): columns are basis coefficient vectors
    return {"nodes": nodes, "exps": exps, "coeff": coeff}


def ndof_el(et: str, order: int) -> int:
    return lagrange_element(et, order)["nodes"].shape[0]
