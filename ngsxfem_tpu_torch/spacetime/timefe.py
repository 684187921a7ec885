"""Time finite elements on the reference interval [0,1].

Counterpart of ``ngsxfem_tpu/spacetime/timefe.py`` (the reference's
``NodalTimeFE``, spacetime/SpaceTimeFE.hpp:50-97): Lagrange elements on
Gauss-Lobatto nodes, evaluated through a precomputed monomial coefficient
matrix, so a batch of time-basis values is one matrix product.  Contexts
carry an explicit ``time`` tensor in place of the reference's weight-slot
convention (SpaceTimeFE.cpp:39-41).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.gauss import gauss_lobatto_01


@lru_cache(maxsize=None)
def time_nodes(order: int):
    if order == 0:
        return np.array([1.0])
    x, _ = gauss_lobatto_01(order + 1)
    return np.asarray(x)


@lru_cache(maxsize=None)
def _time_coeff(order: int):
    nodes = time_nodes(order)
    V = np.vander(nodes, N=order + 1, increasing=True)  # V[i,j] = t_i^j
    return np.linalg.inv(V)  # (nm, nd): shapes(t) = mono(t) @ C


class ScalarTimeFE:
    """Nodal Lagrange FE in time (factory as the reference's ScalarTimeFE).

    CG-in-time variants (reference NodalTimeFE, SpaceTimeFE.hpp:50-97 and
    SpaceTimeFE.cpp:116-150): the shape functions are always the full
    Lagrange basis on the Gauss-Lobatto nodes; ``skip_first_node`` drops
    the dof at t=0 (its value comes from the previous slab) and
    ``only_first_node`` keeps only that dof.
    """

    def __init__(self, order: int, skip_first_node=False, only_first_node=False):
        self.order = int(order)
        if skip_first_node and only_first_node:
            raise ValueError("skip_first_node and only_first_node are exclusive")
        self.skip_first_node = skip_first_node
        self.only_first_node = only_first_node
        self.all_nodes = time_nodes(self.order)
        if skip_first_node:
            self._active = np.arange(1, len(self.all_nodes))
        elif only_first_node:
            self._active = np.arange(0, 1)
        else:
            self._active = np.arange(len(self.all_nodes))
        self.nodes = self.all_nodes[self._active]
        self.ndof = len(self._active)

    def IsNodeActive(self, i: int) -> bool:
        if i < 0 or i > self.order:
            raise IndexError("node outside node range")
        if i == 0 and self.skip_first_node:
            return False
        if i != 0 and self.only_first_node:
            return False
        return True

    def _select(self, full):
        if len(self._active) == full.shape[-1]:
            return full
        return full[..., self._active]

    def _combine(self, mono, t):
        """sum_m mono[m] * C[m, :] as multiply-adds in order m = 0, 1, ...
        (a batched matmul would sum in another order on every backend)."""
        C = torch.as_tensor(_time_coeff(self.order), dtype=t.dtype,
                            device=t.device)
        out = mono[0][..., None] * C[0]
        for m in range(1, self.order + 1):
            out = out + mono[m][..., None] * C[m]
        return self._select(out)

    def eval(self, t):
        """shapes (..., nd_t) at times t (...), a tensor."""
        return self._combine([t**j for j in range(self.order + 1)], t)

    def deval(self, t):
        """d/dt shapes (..., nd_t)."""
        return self._combine(
            [torch.zeros_like(t)]
            + [j * t ** (j - 1) for j in range(1, self.order + 1)], t)

    def eval_np(self, t):
        C = _time_coeff(self.order)
        t = np.asarray(t, dtype=np.float64)
        mono = np.stack([t**j for j in range(self.order + 1)], axis=-1)
        return self._select(mono @ C)
