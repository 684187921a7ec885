"""Lattice-sharded DIA operator: slab decomposition and halo exchange.

Counterpart of ``ngsxfem_tpu/parallel/latticeshard.py``.  The vertex lattice
of the flagship's DIA operator (``UnfittedPoisson.dia_structure``) is split
into contiguous slabs of ``L`` planes along its slowest axis, one slab per
rank.  A DIA product needs x only within ``H = ceil(max|offset| / plane)``
planes of the slab, so each product sends the two ``hp = H * plane`` boundary
windows to the two neighbouring ranks (``dist.batch_isend_irecv``, the
counterpart of ``lax.ppermute``); the ring ends receive nothing and keep
zeros, which is the zero padding of the DIA boundary.  When the halo is
wider than a slab (``hp > L * plane``) whole slabs are relayed over several
hops.  Each rank holds only its slab: ``pad_x``/``pad_table`` cut it out of a
whole vector or table, ``gather_x`` puts the whole vector together again
(tests and checks), and ``dot`` is the all-reduced inner product an outer
Krylov loop runs on (``krylov.cg(..., dot=ls.dot)``).
"""
from __future__ import annotations

import numpy as np
import torch


class LatticeShard:
    """Slab-sharded DIA operator over the ranks of a ``ShardGroup``.

    offsets: host ints (DIA diagonals, vertex-lexicographic numbering)
    nv1, d:  lattice extent per axis and dimension (n = nv1**d)
    group:   the ``ShardGroup`` (rank, world size, device)
    """

    def __init__(self, offsets, nv1, d, group):
        self.offsets = [int(o) for o in np.asarray(offsets).tolist()]
        self.nv1 = int(nv1)
        self.d = int(d)
        self.plane = self.nv1 ** (self.d - 1)
        self.n = self.nv1 ** self.d
        self.group = group
        self.ndev = group.world_size
        self.rank = group.rank
        self.H = max(1, int(-(-max(abs(o) for o in self.offsets)
                              // self.plane)))
        # pad the plane axis so every rank owns the same number of planes
        self.L = -(-self.nv1 // self.ndev)
        self.Pn = self.L * self.ndev
        self.n_pad = self.Pn * self.plane
        self.Lp = self.L * self.plane
        self.lo = self.rank * self.Lp  # first padded row of this slab

    # -- slabs ----------------------------------------------------------------
    def pad_x(self, x):
        """This rank's slab (Lp, ...) of a whole (n, ...) lattice vector,
        zero beyond n, on the group's device."""
        x = torch.as_tensor(x).to(self.group.device)
        out = x.new_zeros((self.Lp,) + tuple(x.shape[1:]))
        hi = min(self.lo + self.Lp, self.n)
        if hi > self.lo:
            out[:hi - self.lo] = x[self.lo:hi]
        return out

    def pad_table(self, V):
        """This rank's slab (n_off, Lp) of a whole (n_off, n) DIA table."""
        return self.pad_x(torch.as_tensor(V).transpose(0, 1)) \
            .transpose(0, 1).contiguous()

    def gather_x(self, xl):
        """The whole (n,) vector from every rank's slab (a collective)."""
        return torch.cat(self.group.all_gather(xl))[:self.n]

    def dot(self, a, b):
        """Inner product of two slab vectors over all ranks: each rank's
        part accumulated in float64, summed by one ``all_reduce``, rounded
        once to the working dtype (``krylov._vdot``'s rule)."""
        s = torch.dot(a.double(), b.double()).reshape(1)
        return self.group.all_reduce(s)[0].to(a.dtype)

    # -- halo exchange ----------------------------------------------------------
    def halo(self, xl, h):
        """(from_prev, from_next): the ``h`` rows of the whole vector just
        before and just after this rank's slab ``xl`` (rows = leading axis,
        zeros beyond the ring ends).  One exchange with each neighbour when
        ``h <= Lp``; else whole slabs relayed over ``ceil(h / Lp)`` hops."""
        g, r, nd = self.group, self.rank, self.ndev
        xl = xl.contiguous()
        zero = xl.new_zeros((h,) + tuple(xl.shape[1:]))
        if nd == 1:
            return zero, zero.clone()
        Lp = xl.shape[0]
        if h <= Lp:
            from_prev, from_next = zero, zero.clone()
            sends, recvs = [], []
            if r + 1 < nd:
                sends.append((xl[Lp - h:].contiguous(), r + 1))
                recvs.append((from_next, r + 1))
            if r > 0:
                sends.append((xl[:h].contiguous(), r - 1))
                recvs.append((from_prev, r - 1))
            g.exchange(sends, recvs)
            return from_prev, from_next
        hops = -(-h // Lp)
        prev_parts, next_parts = [], []
        cur_f, cur_b = xl, xl
        for _ in range(hops):
            new_f, new_b = torch.zeros_like(xl), torch.zeros_like(xl)
            sends, recvs = [], []
            if r + 1 < nd:
                sends.append((cur_f, r + 1))
                recvs.append((new_b, r + 1))
            if r > 0:
                sends.append((cur_b, r - 1))
                recvs.append((new_f, r - 1))
            g.exchange(sends, recvs)
            cur_f, cur_b = new_f, new_b
            prev_parts.insert(0, cur_f)
            next_parts.append(cur_b)
        return torch.cat(prev_parts)[-h:], torch.cat(next_parts)[:h]

    # -- sharded matvec ---------------------------------------------------------
    def matvec(self, Vl, xl):
        """y = A x on this rank's slab: Vl (n_off, Lp), xl (Lp,).  Each row
        sums its diagonals in the order of ``sparse.dia_matvec``, so the
        slab rows equal the single-device product's bit for bit."""
        hp = self.H * self.plane
        from_prev, from_next = self.halo(xl, hp)
        xe = torch.cat([from_prev, xl, from_next])
        Lp = self.Lp
        y = None
        for k, o in enumerate(self.offsets):
            t = Vl[k] * xe[hp + o:hp + o + Lp]
            y = t if y is None else y + t
        return y
