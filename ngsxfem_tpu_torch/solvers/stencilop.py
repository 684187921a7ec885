"""Channel-lattice stencil operator: a gather-free matvec on structured meshes.

Counterpart of ``ngsxfem_tpu/solvers/stencilop.py``.  On a structured
simplex lattice the order-k Lagrange dofs sit on the refined lattice of
spacing h/k: scaling a dof's position by k/h gives integer coordinates q,
and the parity p = q mod k assigns the dof to one of k^dim CHANNELS, with
SITE s = q // k on the cell lattice.  Every matrix entry (i, j) then lives
on a (channel_i, channel_j, site_j - site_i) stencil whose offset is bounded
by the form's support (|offset|_inf <= 1 for element and facet-patch
couplings), so ``y = A x`` is a sum of shifted-window products over the site
grid (the order-k generalization of the flagship's 27-diagonal P1 DIA path).

The port keeps the tables dense per present offset, ``(noff, nchan, nchan,
*dims)`` with zeros for absent (ci, cj) pairs, built on the device of the
element batches by one fixed-order sum (``ops.scatter.ScatterPlan``): the
sequential sum of the triplet stream, bit for bit what ``np.add.at`` gives on
the host.  (Above order 1 a facet-patch coupling reaches two sites, so the
reach is 2, but only 27 of the 125 offsets of 3D occur.)  Two applies:

* ``stencil_apply_plain``: one shifted-window multiply-add per present
  combo, in the JAX package's combo order (the CPU path);
* ``stencil_apply_offsets``: per offset, the shifted window of the padded
  input taken once and contracted over ``cj`` by a broadcast multiply and a
  sum, a bounded number of kernels per offset whatever the order (the card
  path: up to 8*8*27 = 1,728 combos at P2 in 3D would each cost two kernel
  launches in the plain loop).

``stencil_guard`` bounds the reach and the tables' bytes, which the JAX
package leaves unchecked; ``BilinearForm.AssembleOperator`` falls back to
``PartialAssemblyOperator`` under ``lattice="auto"`` when the guard fails.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.scatter import ScatterPlan

# limits of the dense tables: the site-offset reach of the form's couplings
# (1 for P1 element and facet-patch couplings, 2 above order 1) and the
# tables' bytes (2.46 GB at P3 nx=24); past either, lattice="auto" takes
# the partial assembly and lattice=True raises
STENCIL_MAX_REACH = 2
STENCIL_MAX_BYTES = 8 << 30


def lattice_dof_map(space):
    """dof -> (channel, site) for a Lagrange space whose dof nodes form a
    uniform lattice (host numpy).  None when they don't (unstructured mesh,
    non-simplex elements, spaces without nodal dof representatives)."""
    mesh = getattr(space, "mesh", None)
    order = getattr(space, "order", 0)
    if mesh is None or order < 1:
        return None
    if getattr(space, "dof_rep_elem", None) is None:
        return None
    V = np.asarray(mesh.vertices_np, dtype=np.float64)
    dim = V.shape[1]
    if dim not in (2, 3):
        return None
    ev = mesh.elements_np[space.dof_rep_elem]          # (ndof, nvert)
    if ev.shape[1] != dim + 1:                         # simplices only
        return None
    verts = V[ev]                                      # (ndof, nvert, dim)
    ref = np.asarray(space.dof_rep_ref, dtype=np.float64)
    phys = verts[:, 0] + np.einsum(
        "ndk,nd->nk", verts[:, 1:] - verts[:, :1], ref)
    # per-axis vertex lattice: uniform spacing or bail
    axes = []
    for d in range(dim):
        u = np.unique(np.round(V[:, d], 10))
        if len(u) < 2:
            return None
        steps = np.diff(u)
        if not np.allclose(steps, steps[0], rtol=1e-6, atol=1e-12):
            return None
        axes.append(u)
    h = np.array([a[1] - a[0] for a in axes])
    mins = np.array([a[0] for a in axes])
    q = (phys - mins) / (h / order)
    qi = np.rint(q).astype(np.int64)
    if not np.allclose(q, qi, atol=1e-6):
        return None
    par = qi % order
    site = qi // order
    nchan = order ** dim
    chan = np.zeros(len(qi), dtype=np.int64)
    for d in range(dim):
        chan = chan * order + par[:, d]
    dims = tuple(len(a) for a in axes)                 # site grid extents
    if site.min() < 0 or (site >= np.array(dims)).any():
        return None
    # bijectivity: every dof owns a distinct (channel, site) slot
    flat = chan
    for d in range(dim):
        flat = flat * dims[d] + site[:, d]
    if len(np.unique(flat)) != space.ndof or len(flat) != space.ndof:
        return None
    return {"chan": chan, "site": site, "dims": dims, "nchan": nchan,
            "dim": dim}


class StencilTooLarge(ValueError):
    """The dense tables of a form would exceed ``stencil_guard``'s limits."""


def stencil_guard(reach, noff, nchan, dims, itemsize):
    """None when the dense tables of ``noff`` present offsets fit
    ``STENCIL_MAX_REACH`` and ``STENCIL_MAX_BYTES``, else the reason."""
    if reach > STENCIL_MAX_REACH:
        return f"stencil reach {reach} exceeds {STENCIL_MAX_REACH}"
    nbytes = noff * nchan * nchan * int(np.prod(dims)) * itemsize
    if nbytes > STENCIL_MAX_BYTES:
        return (f"stencil tables of {nbytes} bytes exceed "
                f"{STENCIL_MAX_BYTES} bytes")
    return None


def _offsets(o, reach, dim):
    """Offset vector of offset index ``o`` (mixed radix, last axis fastest)."""
    span = 2 * reach + 1
    offs = []
    for _ in range(dim):
        offs.append(o % span - reach)
        o //= span
    return tuple(reversed(offs))


def _window(reach, offs, dims):
    return tuple(slice(reach + o, reach + o + n) for o, n in zip(offs, dims))


def _to_lattice(x, chan, fs, nchan, dims, reach):
    """Dof vector -> zero-padded channel lattice (nchan, *(dims + 2 reach))."""
    X = x.new_zeros(nchan, int(np.prod(dims)))
    X[chan, fs] = x
    X = X.reshape((nchan,) + tuple(dims))
    return torch.nn.functional.pad(X, (reach, reach) * len(dims))


def stencil_apply_plain(tables, meta, offsets, reach, chan, fs, x):
    """``y = A x`` by one shifted-window multiply-add per present combo
    ``(ci, cj, k)`` of ``meta``, in the JAX package's order (``tables``
    (noff, nchan, nchan, *dims), table k holding offset code
    ``offsets[k]``; ``chan``/``fs`` the dofs' channel and flat site)."""
    nchan, dims = tables.shape[1], tuple(tables.shape[3:])
    Xp = _to_lattice(x, chan, fs, nchan, dims, reach)
    Ys = [x.new_zeros(dims) for _ in range(nchan)]
    for ci, cj, k in meta:
        sl = _window(reach, _offsets(offsets[k], reach, len(dims)), dims)
        Ys[ci] = Ys[ci] + tables[k, ci, cj] * Xp[(cj,) + sl]
    return torch.stack(Ys).reshape(nchan, -1)[chan, fs]


def stencil_apply_offsets(tables, offsets, reach, chan, fs, x):
    """``y = A x`` per offset: for table k (offset code ``offsets[k]``) the
    window of the padded input is taken once and contracted over ``cj``
    with the (nchan, nchan, *dims) table by a broadcast multiply and a
    sum."""
    nchan, dims = tables.shape[1], tuple(tables.shape[3:])
    Xp = _to_lattice(x, chan, fs, nchan, dims, reach)
    Y = x.new_zeros((nchan,) + dims)
    for k, o in enumerate(offsets):
        sl = _window(reach, _offsets(o, reach, len(dims)), dims)
        Y += (tables[k] * Xp[(slice(None),) + sl][None]).sum(1)
    return Y.reshape(nchan, -1)[chan, fs]


class LatticeStencilOperator:
    """``y = A @ x`` as channel-lattice stencil windows (see the module doc).

    Built from the assembled triplet stream ``(rows, cols, vals)`` on one
    device (what ``BilinearForm.Assemble`` gives its matrix) and the
    ``lattice_dof_map`` of the space; equal to the assembled matvec up to
    the order of the sums.  Raises ``StencilTooLarge`` when
    ``stencil_guard`` fails."""

    kind = "stencil"

    def __init__(self, rows, cols, vals, dofmap, nrows):
        dev, dtype = vals.device, vals.dtype
        dims = tuple(int(n) for n in dofmap["dims"])
        nchan, dim = int(dofmap["nchan"]), int(dofmap["dim"])
        chan = torch.as_tensor(dofmap["chan"], dtype=torch.int64, device=dev)
        site = torch.as_tensor(dofmap["site"], dtype=torch.int64, device=dev)
        fs = torch.zeros(len(chan), dtype=torch.int64, device=dev)
        for dd in range(dim):
            fs = fs * dims[dd] + site[:, dd]
        rows, cols = rows.to(torch.int64), cols.to(torch.int64)
        d = site[cols] - site[rows]                       # (N, dim)
        reach = int(d.abs().max()) if len(d) else 1
        span = 2 * reach + 1
        o = torch.zeros(len(rows), dtype=torch.int64, device=dev)
        for dd in range(dim):
            o = o * span + (d[:, dd] + reach)
        del d
        present = torch.unique(o)  # offset codes, ascending
        noff = len(present)
        why = stencil_guard(reach, noff, nchan, dims, vals.element_size())
        if why is not None:
            raise StencilTooLarge(why)
        S = int(np.prod(dims))
        combo = ((torch.searchsorted(present, o) * nchan + chan[rows])
                 * nchan + chan[cols])
        del o
        # the fixed-order sum of the triplets into their (combo, site) slots
        slot = combo * S + fs[rows]
        self.tables = ScatterPlan(slot, noff * nchan * nchan * S,
                                  sequential=True).add(
            vals).reshape((noff, nchan, nchan) + dims)
        del slot
        keys = torch.unique(combo).cpu().numpy()
        k_, rest = keys // (nchan * nchan), keys % (nchan * nchan)
        # present combos in the JAX package's order: (ci, cj, offset), the
        # table index k ascending with the offset code
        self.meta = sorted(zip((rest // nchan).tolist(),
                               (rest % nchan).tolist(), k_.tolist()))
        self.offsets = present.tolist()
        self.reach, self.dims, self.nchan = reach, dims, nchan
        self.chan, self.fs = chan, fs
        self.shape = (nrows, nrows)
        self.ncombo = len(self.meta)
        self.device, self.dtype = dev, dtype

    def matvec(self, x):
        """On a CUDA tensor the per-offset apply, on the CPU the plain one."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if x.is_cuda:
            return stencil_apply_offsets(self.tables, self.offsets,
                                         self.reach, self.chan, self.fs, x)
        return stencil_apply_plain(self.tables, self.meta, self.offsets,
                                   self.reach, self.chan, self.fs, x)

    __matmul__ = matvec

    def __mul__(self, x):
        return self.matvec(x)

    def diagonal(self):
        """Exact matrix diagonal (Jacobi preconditioner): the (c, c) tables
        of the zero offset."""
        center = (2 * self.reach + 1) ** len(self.dims) // 2
        if center not in self.offsets:
            return torch.zeros(len(self.chan), dtype=self.dtype,
                               device=self.device)
        dg = torch.diagonal(self.tables[self.offsets.index(center)], dim1=0,
                            dim2=1)
        return dg.movedim(-1, 0).reshape(self.nchan, -1)[self.chan, self.fs]

    def nbytes(self):
        """Bytes of the stencil tables."""
        return int(self.tables.numel() * self.tables.element_size())
