"""Nodal Lagrange bases (host tables).

Counterpart of ``ngsxfem_tpu/fem/basis.py``: the monomial-coefficient
matrix per (element type, order), ``shape_i(p) = sum_m mono_m(p) * C[m, i]``,
with classical equispaced Lagrange nodes, its evaluation on numpy arrays or
tensors, the reference gradients ``dshapes`` (tensors) and the facet node
sets.
"""
from __future__ import annotations

from functools import lru_cache
from itertools import product

import numpy as np
import torch

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


def eval_monomials(exps, pts):
    """mono (..., nm) at pts (..., d); exps (nm, d) host ints.  ``pts`` is a
    numpy array or a tensor, and the result is of the same kind."""
    nm, d = exps.shape
    cols = []
    for m in range(nm):
        v = None
        for j in range(d):
            e = int(exps[m, j])
            if e == 0:
                continue
            p = pts[..., j] ** e
            v = p if v is None else v * p
        if v is None:
            v = (torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
                 if torch.is_tensor(pts)
                 else np.ones(pts.shape[:-1], dtype=pts.dtype))
        cols.append(v)
    if torch.is_tensor(pts):
        return torch.stack(cols, dim=-1)
    return np.stack(cols, axis=-1)


def shapes(et: str, order: int, pts):
    """All shape functions at reference pts (..., d) -> (..., nd), on numpy
    arrays or tensors."""
    b = lagrange_element(et, order)
    mono = eval_monomials(b["exps"], pts)
    if torch.is_tensor(pts):
        C = torch.as_tensor(b["coeff"], dtype=pts.dtype, device=pts.device)
    else:
        C = np.asarray(b["coeff"], dtype=pts.dtype)
    return mono @ C


def eval_dmonomials(exps, pts, axis: int):
    """d(mono)/d(pts[axis]) (..., nm) at tensor pts (..., d)."""
    nm, d = exps.shape
    cols = []
    for m in range(nm):
        e_ax = int(exps[m, axis])
        if e_ax == 0:
            cols.append(torch.zeros(pts.shape[:-1], dtype=pts.dtype,
                                    device=pts.device))
            continue
        v = torch.full(pts.shape[:-1], float(e_ax), dtype=pts.dtype,
                       device=pts.device)
        for j in range(d):
            e = int(exps[m, j]) - (1 if j == axis else 0)
            if e > 0:
                v = v * pts[..., j] ** e
        cols.append(v)
    return torch.stack(cols, dim=-1)


def dshapes(et: str, order: int, pts):
    """Reference gradients at tensor pts (..., d) -> (..., nd, d)."""
    b = lagrange_element(et, order)
    C = torch.as_tensor(b["coeff"], dtype=pts.dtype, device=pts.device)
    d = pts.shape[-1]
    grads = [eval_dmonomials(b["exps"], pts, ax) @ C for ax in range(d)]
    return torch.stack(grads, dim=-1)


def ndof_el(et: str, order: int) -> int:
    return lagrange_element(et, order)["nodes"].shape[0]


def facet_local_nodes(et: str, order: int, interior_only: bool = False):
    """Per local facet: local Lagrange node ids belonging to the facet.

    interior_only=False: the facet closure, nodes with no support on any
    off-facet vertex.  interior_only=True: nodes supported on every facet
    vertex as well, the NT_FACET dofs (NGSolve GetDofNrs(NodeId(NT_FACET,
    f)) analog)."""
    from ..mesh.mesh import FACET_VERTS, geom_shapes

    b = lagrange_element(et, order)
    N = geom_shapes(et, b["nodes"])  # (ndl, nv) host numpy
    sup = N > 1e-9
    out = []
    for fvs in FACET_VERTS[et]:
        mask = np.ones(len(N), dtype=bool)
        for v in range(N.shape[1]):
            if v in fvs:
                if interior_only:
                    mask &= sup[:, v]
            else:
                mask &= ~sup[:, v]
        out.append(np.nonzero(mask)[0])
    return out
