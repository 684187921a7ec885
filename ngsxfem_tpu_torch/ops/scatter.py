"""Scatter-add in a fixed order: the same sums on every run and device.

``index_add_`` is sequential on the CPU but atomic on a CUDA card, where the
order of the adds into one slot, and so the last bits of the result, changes
from run to run.  A ``ScatterPlan`` sorts an index stream once, stably, by
target slot, and numbers each slot's contributions in stream order.  Adding
rank by rank, every ``index_add_`` writes each slot at most once, so no two
of its adds meet, and every slot receives its contributions in stream order:
the sequential sum, bit for bit, on the CPU and on the card alike.

A slot with more than ``CHUNK`` contributions would need as many passes, so
its contributions are first summed in chunks of ``CHUNK`` consecutive ones
(each chunk in stream order, the same way), and the chunk sums, in order,
take their place: one more level of the plan.  The order is then fixed by
the index stream alone.  The cost is one gather and at most ``CHUNK``
``index_add_`` passes per level; the 3D flagship's assembly (up to ~160
contributions to one ghost-penalty slot) takes two levels.
"""
from __future__ import annotations

import torch

CHUNK = 32  # the most passes of one level


class _Level:
    """One level: ``src`` (positions into the level's input stream) and
    ``dst`` (their slots in its output of ``nout``), ordered by (rank,
    slot); ``splits`` the number of entries of each rank."""

    def __init__(self, src, dst, splits, nout):
        self.src, self.dst, self.splits, self.nout = src, dst, splits, nout

    def add(self, values, out):
        vals = values.index_select(0, self.src)
        start = 0
        for count in self.splits:
            stop = start + count
            out.index_add_(0, self.dst[start:stop], vals[start:stop])
            start = stop
        return out


class ScatterPlan:
    """The fixed-order plan of ``index`` (1-D integer tensor, entries in
    [0, n)) on its device; its ``levels`` (host reads happen here, once).
    With ``sequential=True`` there is one level however many contributions
    a slot has (as many passes as the largest count): the sequential sum
    of the stream, bit for bit what ``np.add.at`` gives."""

    def __init__(self, index, n, sequential=False):
        self.n = n
        self.levels = []
        slots = index.reshape(-1).to(torch.int64)
        while True:
            m = slots.numel()
            dev = slots.device
            order = torch.argsort(slots, stable=True)
            sorted_slots = slots[order]
            rank = (torch.arange(m, device=dev)
                    - torch.searchsorted(sorted_slots, sorted_slots))
            it = torch.int32 if max(m, n) < 2**31 else torch.int64
            if m == 0 or sequential or int(rank.max()) < CHUNK:
                by_rank = torch.argsort(rank, stable=True)
                self.levels.append(_Level(
                    order[by_rank].to(it), sorted_slots[by_rank].to(it),
                    torch.bincount(rank).tolist() if m else [], n))
                return
            # chunks of CHUNK consecutive contributions to one slot, in
            # (slot, stream) order; their sums are the next level's stream
            first = rank % CHUNK == 0
            chunk = torch.cumsum(first.to(torch.int64), 0) - 1
            by_rank = torch.argsort(rank % CHUNK, stable=True)
            self.levels.append(_Level(
                order[by_rank].to(it), chunk[by_rank].to(it),
                torch.bincount(rank % CHUNK).tolist(), int(chunk[-1]) + 1))
            slots = sorted_slots[first]

    def add(self, values, out=None):
        """``out`` (default zeros of n) plus the stream ``values`` (as long
        as the index) scattered into its slots in the plan's fixed order."""
        values = values.reshape(-1)
        if out is None:
            out = torch.zeros(self.n, dtype=values.dtype, device=values.device)
        for level in self.levels[:-1]:
            values = level.add(values, torch.zeros(
                level.nout, dtype=values.dtype, device=values.device))
        return self.levels[-1].add(values, out)

