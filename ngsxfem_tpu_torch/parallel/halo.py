"""Dof-sharded partitioning: interior/shared dof decomposition (host numpy).

Counterpart of ``ngsxfem_tpu/parallel/halo.py``, kept as its own copy: the
port imports nothing of the JAX package.  Elements are partitioned into
contiguous chunks, one per rank, and every dof is classified as *interior*
to exactly one chunk or *shared* (touched by rows of more than one chunk).
Interior dofs live on their chunk's rank and need no communication; only the
shared-dof buffer (the halo layer, O(ranks * N^(d-1)/d) dofs for slab
partitions) is summed by one ``all_reduce`` per operator application
(``UnfittedPoisson.spmd_step_sharded``), so the payload is proportional to
the halo, not to ndof.  The tables are the reference's, bit for bit.
"""
from __future__ import annotations

import numpy as np


class DofPartition:
    """Host-side partition tables.

    Layout per device c: local vector = [interior dofs of c (padded to
    Ni_max) | shared dofs (S, replicated)].  `e2d_local` indexes this layout.
    """

    def __init__(self, ndof: int, row_dofmaps, row_chunks, n: int):
        """row_dofmaps: list of (R_i, nd_i) global-dof row maps (elements,
        facet patches, ...); row_chunks: matching (R_i,) chunk assignment.
        Dof maps must be dense (no -1 padding entries)."""
        self.n = n
        self.ndof = ndof
        # O(ndof) classification: first chunk touching each dof + a
        # multi-touched flag (instead of a dense (n, ndof) touch table)
        first = np.full(ndof, -1, dtype=np.int32)
        multi = np.zeros(ndof, dtype=bool)
        for dm, ch in zip(row_dofmaps, row_chunks):
            dm = np.asarray(dm)
            if dm.size and dm.min() < 0:
                raise ValueError(
                    "DofPartition dofmap contains negative dof ids "
                    "(padding rows must be dropped before partitioning)")
            for c in range(n):
                sel = np.unique(dm[ch == c])
                if not len(sel):
                    continue
                seen = first[sel]
                new = seen < 0
                first[sel[new]] = c
                multi[sel[(~new) & (seen != c)]] = True
        self.shared = multi
        untouched = first < 0
        # untouched dofs (e.g. inactive far-field dofs) are distributed
        # round-robin as interior so every dof has exactly one owner
        owner = np.where(~multi, first, -1).astype(np.int32)
        nun = int(untouched.sum())
        if nun:
            owner[untouched] = np.arange(nun, dtype=np.int32) % n
        self.sh_ids = np.nonzero(multi)[0].astype(np.int32)
        self.S = len(self.sh_ids)
        int_mask = ~multi
        self.Ni = np.bincount(owner[int_mask], minlength=n)
        self.Ni_max = int(self.Ni.max()) if n else 0
        self.int_ids = np.full((n, self.Ni_max), -1, dtype=np.int32)
        # single (ndof,) local-slot table: interior -> slot in the owner
        # chunk, shared -> Ni_max + shared slot (identical on every chunk)
        loc = np.full(ndof, -1, dtype=np.int32)
        for c in range(n):
            ids = np.nonzero(int_mask & (owner == c))[0].astype(np.int32)
            self.int_ids[c, :len(ids)] = ids
            loc[ids] = np.arange(len(ids), dtype=np.int32)
        loc[self.sh_ids] = self.Ni_max + np.arange(self.S, dtype=np.int32)
        self.loc = loc
        self.owner = owner

    def localize_rows(self, dofmap, chunks):
        """(R, nd) global dof map -> (R, nd) local-layout indices per row's
        chunk.  Every referenced dof must be interior-to-that-chunk or shared."""
        dofmap = np.asarray(dofmap)
        if dofmap.size and dofmap.min() < 0:
            raise ValueError("localize_rows dofmap contains negative dof ids")
        chunks = np.asarray(chunks)
        visible = self.shared[dofmap] | (self.owner[dofmap] == chunks[:, None])
        if not visible.all():
            raise ValueError("row references a dof not visible to its chunk")
        return self.loc[dofmap].astype(np.int32)

    def split_vector(self, x):
        """global (ndof,) -> (x_int (n, Ni_max), x_sh (S,)) host numpy."""
        x = np.asarray(x)
        x_int = np.zeros((self.n, self.Ni_max), dtype=x.dtype)
        for c in range(self.n):
            ids = self.int_ids[c]
            m = ids >= 0
            x_int[c, m] = x[ids[m]]
        return x_int, x[self.sh_ids]

    def merge_vector(self, x_int, x_sh):
        """inverse of split_vector."""
        out = np.zeros(self.ndof, dtype=np.asarray(x_sh).dtype)
        for c in range(self.n):
            ids = self.int_ids[c]
            m = ids >= 0
            out[ids[m]] = np.asarray(x_int)[c, m]
        out[self.sh_ids] = np.asarray(x_sh)
        return out
