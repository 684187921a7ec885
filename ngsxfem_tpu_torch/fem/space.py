"""Finite element spaces: dof maps, and boolean mark arrays.

Counterpart of ``ngsxfem_tpu/fem/space.py``: ``BitArray`` and
``CompoundBitArray`` (host boolean marks with NGSolve-like set algebra), the
``FESpace`` base (boundary and Dirichlet dof marks, ``FreeDofs``, trial/test
proxies), ``H1``, ``L2`` and ``NumberSpace`` on it, ``VectorFESpace``
(``VectorH1``/``VectorL2``), ``CompoundFESpace`` (the exported
``FESpace([...])``), ``CompressedFESpace``/``Compress``,
``GetDofsOfElements`` and the periodic identification ``Periodic``.  A
space's host dof map is ``el2dof_np (ne, ndl)`` and ``ndof``, with a device
view ``el2dof``.  Global dof numbering uses an
*exact integer barycentric fingerprint* per Lagrange node (vertex ids +
integer weights), deduplicated in first-appearance order by the native
topology library, exactly as the reference package numbers its dofs.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ..config import resolve_device
from ..mesh.mesh import Mesh, geom_shapes
from ..ops.gauss import ET_NVERT
from ..utils.timing import traced
from .basis import facet_local_nodes, lagrange_element, ndof_el


class BitArray:
    """Boolean mark array (host numpy) with NGSolve-like set algebra."""

    def __init__(self, data):
        self.a = np.asarray(data, dtype=bool)

    def __and__(self, o):
        return BitArray(self.a & _arr(o))

    def __or__(self, o):
        return BitArray(self.a | _arr(o))

    def __invert__(self):
        return BitArray(~self.a)

    def __iand__(self, o):
        self.a &= _arr(o)
        return self

    def __ior__(self, o):
        self.a |= _arr(o)
        return self

    def __getitem__(self, i):
        return self.a[i]

    def __setitem__(self, i, v):
        self.a[i] = v

    def __len__(self):
        return len(self.a)

    def __iter__(self):
        return iter(self.a)

    def NumSet(self):
        return int(self.a.sum())

    def Set(self, i=None):
        if i is None:
            self.a[:] = True
        else:
            self.a[i] = True

    def Clear(self, i=None):
        if i is None:
            self.a[:] = False
        else:
            self.a[i] = False

    @property
    def np(self):
        return self.a

    def __repr__(self):
        return f"BitArray({self.a.sum()}/{len(self.a)} set)"


def _arr(o):
    """The bool mark array of a ``BitArray``, a ``Region`` (its element
    mask) or anything ``np.asarray`` takes."""
    if isinstance(o, BitArray):
        return o.a
    if hasattr(o, "Mask"):
        return o.Mask()
    return np.asarray(o, dtype=bool)


def CompoundBitArray(arrays):
    """Concatenate BitArrays (cf. utils/python_utils.cpp:155-184)."""
    return BitArray(np.concatenate([_arr(a) for a in arrays]))


def _node_fingerprints(mesh: Mesh, order: int):
    """Exact integer fingerprints of all element-local Lagrange nodes.

    Returns (keys (ne*ndl, 2*nv) int64, ndl).
    """
    et = mesh.et
    b = lagrange_element(et, order)
    nodes = b["nodes"]  # (ndl, d)
    nv = ET_NVERT[et]
    N = geom_shapes(et, nodes)  # (ndl, nv)
    k = max(order, 1)
    den = k ** (1 if et in ("segm", "trig", "tet") else mesh.dim)
    W = np.rint(N * den).astype(np.int64)  # exact integer weights
    assert np.allclose(W / den, N, atol=1e-9), "non-exact node weights"
    ndl = nodes.shape[0]
    ne = mesh.ne
    vids = mesh.elements_np[:, None, :].repeat(ndl, axis=1).astype(np.int64)  # (ne,ndl,nv)
    Wb = np.broadcast_to(W[None], (ne, ndl, nv)).copy()
    # null out vertex ids with zero weight, then sort pairs for canonical form
    vids = np.where(Wb > 0, vids, -1)
    comp = vids.reshape(-1, nv) * np.int64(den + 2) + Wb.reshape(-1, nv)
    ordr = np.argsort(comp, axis=-1)
    vs = np.take_along_axis(vids.reshape(-1, nv), ordr, axis=-1)
    ws = np.take_along_axis(Wb.reshape(-1, nv), ordr, axis=-1)
    keys = np.concatenate([vs, ws], axis=-1)  # (ne*ndl, 2nv)
    return keys, ndl


class DeviceViews:
    """Device views of a space's host dof tables: ``el2dof_np`` on the
    space's device (``_device``: the card unless the space was given
    ``device="cpu"``; without a card and without that argument it raises
    on first use)."""

    @property
    def device(self):
        return resolve_device(self._device)

    @property
    def el2dof(self):
        """(ne, ndl) int64 dof map on the space's device."""
        return self.el2dof_on(self.device)

    def el2dof_on(self, device):
        """(ne, ndl) int64 dof map on ``device``, made once per device."""
        return self._view("el2dof", self.el2dof_np, torch.int64, device)

    def el2dof_valid_on(self, device):
        """(ne, ndl) bool on ``device``: False on the placeholder slots of a
        masked space (``el2dof_valid_np``); None for an unmasked space."""
        valid = getattr(self, "el2dof_valid_np", None)
        if valid is None:
            return None
        return self._view("el2dof_valid", valid, torch.bool, device)

    def _view(self, name, host, dtype, device):
        """The host table ``host`` as a tensor of ``dtype`` on ``device``,
        made once per name, device and dtype."""
        key = (name, str(torch.device(device)), dtype)
        if key not in self._views:
            self._views[key] = torch.as_tensor(host, dtype=dtype,
                                               device=device)
        return self._views[key]


class FESpace(DeviceViews):
    """Base scalar space; subclasses: ``H1``, ``L2``, ``NumberSpace``.

    The dof map is host numpy (``el2dof_np``).  ``el2dof`` is its int64
    view on ``device``, made on first use.  ``dirichlet`` is a list of
    boundary ids or a regex over the mesh's boundary names."""

    vdim = 1
    is_compound = False

    def __init__(self, mesh: Mesh, order: int = 1, dirichlet=None,
                 dgjumps=False, device=None):
        self.mesh = mesh
        self.order = int(order)
        self.dgjumps = dgjumps
        self.dirichlet_spec = dirichlet
        self._device = device
        self._views = {}
        self._build()
        self._mark_boundary_dofs()
        self.dirichlet_dofs = self._dirichlet_mask(dirichlet)

    def _build(self):
        raise NotImplementedError

    @property
    def ndof_el(self):
        return ndof_el(self.mesh.et, self.order)

    # -- boundary / dirichlet ------------------------------------------------
    def _mark_boundary_dofs(self):
        self.bc_of_dof = np.zeros(self.ndof, dtype=np.int32)
        # every local facet of an element type carries the same number of
        # nodes; facets are visited in ascending order and numpy assigns a
        # repeated index its last value, as the reference's facet loop does
        lfn = np.stack(facet_local_nodes(self.mesh.et, self.order))
        m = self.mesh
        bf = m.boundary_facets_np
        e, lf = m.facet2el_np[bf, 0], m.facet2elloc_np[bf, 0]
        dofs = self.el2dof_np[e[:, None], lfn[lf]]  # (B, k)
        self.bc_of_dof[dofs.ravel()] = np.repeat(m.bc_of_facet_np[bf],
                                                 lfn.shape[1])

    def _dirichlet_mask(self, dirichlet):
        """Boolean dof mask for a dirichlet spec (regex or id list); pure."""
        diri = np.zeros(self.ndof, dtype=bool)
        if dirichlet:
            if isinstance(dirichlet, str):
                pat = re.compile(dirichlet)
                ids = {bid for bid, name in self.mesh.bc_names.items()
                       if pat.fullmatch(name)}
            else:
                ids = set(int(b) for b in dirichlet)
            for b in ids:
                diri |= self.bc_of_dof == b
        return diri

    def FreeDofs(self, coupling=False):
        return BitArray(~self.dirichlet_dofs)

    # -- proxies -------------------------------------------------------------
    def TrialFunction(self):
        from ..forms.proxies import make_proxies

        return make_proxies(self, test=False)

    def TestFunction(self):
        from ..forms.proxies import make_proxies

        return make_proxies(self, test=True)

    def TnT(self):
        return self.TrialFunction(), self.TestFunction()

    def Update(self):
        pass

    def __repr__(self):
        return f"{type(self).__name__}(order={self.order}, ndof={self.ndof})"


class H1(FESpace):
    """Continuous Lagrange space of given order (cf. NGSolve H1).

    Besides the dof map it holds the dof representatives
    ``dof_rep_elem``/``dof_rep_local``/``dof_rep_ref`` (an element holding
    each dof and the dof's reference node there, for nodal interpolation)."""

    def _build(self):
        mesh = self.mesh
        keys, ndl = _node_fingerprints(mesh, self.order)
        from ..mesh.native import dedup_rows

        out = dedup_rows(keys)
        if out is not None:
            self.ndof, inv, first = out
        else:
            uniq, first, inv = np.unique(keys, axis=0, return_index=True,
                                         return_inverse=True)
            self.ndof = uniq.shape[0]
        self.el2dof_np = inv.reshape(mesh.ne, ndl).astype(np.int32)
        b = lagrange_element(mesh.et, self.order)
        first = np.asarray(first)
        self.dof_rep_elem = (first // ndl).astype(np.int32)
        self.dof_rep_local = (first % ndl).astype(np.int32)
        self.dof_rep_ref = b["nodes"][self.dof_rep_local]


class L2(FESpace):
    """Element-wise discontinuous Lagrange space (cf. NGSolve L2): the dofs
    of element e are e*ndl .. e*ndl + ndl - 1."""

    def _build(self):
        ndl = self.ndof_el
        ne = self.mesh.ne
        self.ndof = ne * ndl
        self.el2dof_np = np.arange(ne * ndl, dtype=np.int32).reshape(ne, ndl)
        b = lagrange_element(self.mesh.et, self.order)
        self.dof_rep_elem = np.repeat(np.arange(ne, dtype=np.int32), ndl)
        self.dof_rep_local = np.tile(np.arange(ndl, dtype=np.int32), ne)
        self.dof_rep_ref = b["nodes"][self.dof_rep_local]


class NumberSpace(FESpace):
    """One global dof with constant-1 basis (NGSolve FESpace("number")):
    the Lagrange multiplier of a zero-mean pressure constraint."""

    def __init__(self, mesh, order=0, dirichlet=None, device=None, **kw):
        super().__init__(mesh, order=0, dirichlet=None, device=device)

    def _build(self):
        self.ndof = 1
        self.el2dof_np = np.zeros((self.mesh.ne, 1), dtype=np.int32)
        b = lagrange_element(self.mesh.et, 0)
        self.dof_rep_elem = np.zeros(1, dtype=np.int32)
        self.dof_rep_local = np.zeros(1, dtype=np.int32)
        self.dof_rep_ref = b["nodes"]

    def _mark_boundary_dofs(self):
        self.bc_of_dof = np.zeros(1, dtype=np.int32)


class VectorFESpace(FESpace):
    """Vector-valued version of a scalar space in block dof layout:
    component c holds dofs [c*nscal, (c+1)*nscal).  ``el2dof_np`` is the
    scalar map; the component offsets are applied where it is used."""

    def __init__(self, scalar_space: FESpace, vdim=None):
        self.scalar = scalar_space
        self.mesh = scalar_space.mesh
        self.order = scalar_space.order
        self.vdim = vdim or self.mesh.dim
        self.ndof = scalar_space.ndof * self.vdim
        self.el2dof_np = scalar_space.el2dof_np
        v = getattr(scalar_space, "el2dof_valid_np", None)
        if v is not None:  # masked scalar base (Compress): forward it
            self.el2dof_valid_np = v
        self.dirichlet_dofs = np.tile(scalar_space.dirichlet_dofs, self.vdim)
        self.bc_of_dof = np.tile(scalar_space.bc_of_dof, self.vdim)
        self.dgjumps = scalar_space.dgjumps
        self._device = scalar_space._device
        self._views = {}

    @property
    def nscal(self):
        return self.scalar.ndof

    def block_el2dof_on(self, device):
        """(ne, vdim*ndl) int64 dof map of all components on ``device``:
        component c's columns are the scalar map + c*nscal."""
        e2d = self.el2dof_on(device)
        return torch.cat([e2d + c * self.nscal for c in range(self.vdim)],
                         dim=1)


def VectorH1(mesh, order=1, dirichlet=None, **kw):
    return VectorFESpace(H1(mesh, order=order, dirichlet=dirichlet, **kw))


def VectorL2(mesh, order=1, **kw):
    return VectorFESpace(L2(mesh, order=order, **kw))


class CompoundFESpace:
    """Product space FESpace([V0, V1, ...]) with blocked global numbering."""

    is_compound = True

    def __init__(self, spaces, dgjumps=False):
        self.components = list(spaces)
        self.mesh = spaces[0].mesh
        self.dgjumps = dgjumps
        self._device = spaces[0]._device
        self.offsets = np.cumsum([0] + [s.ndof for s in spaces]).astype(np.int64)
        self.ndof = int(self.offsets[-1])

    @property
    def device(self):
        return resolve_device(self._device)

    def Range(self, i):
        return slice(int(self.offsets[i]), int(self.offsets[i + 1]))

    def FreeDofs(self, coupling=False):
        return CompoundBitArray([s.FreeDofs(coupling) for s in self.components])

    def TrialFunction(self):
        from ..forms.proxies import make_proxies

        return tuple(make_proxies(s, test=False, compound=(self, i))
                     for i, s in enumerate(self.components))

    def TestFunction(self):
        from ..forms.proxies import make_proxies

        return tuple(make_proxies(s, test=True, compound=(self, i))
                     for i, s in enumerate(self.components))

    def TnT(self):
        return self.TrialFunction(), self.TestFunction()

    def __repr__(self):
        return f"CompoundFESpace({len(self.components)} spaces, ndof={self.ndof})"


def FESpaceList(spaces, dgjumps=False, **kw):
    """NGSolve-style FESpace([V1,V2]) constructor."""
    return CompoundFESpace(spaces, dgjumps=dgjumps)


def FESpaceFactory(arg, dgjumps=False, **kw):
    """The exported ``FESpace``: ``FESpace([A, B])`` as in NGSolve."""
    if isinstance(arg, (list, tuple)):
        return CompoundFESpace(arg, dgjumps=dgjumps)
    raise TypeError("FESpace factory expects a list of spaces")


class CompressedFESpace(FESpace):
    """Restriction of a space to an active dof set, cf. NGSolve Compress used
    by the fictitious-domain tutorials (py_tutorials/fictdom_ghostpen.py:57)."""

    def __init__(self, base: FESpace, active: BitArray):
        self.base = base
        self.mesh = base.mesh
        self.order = base.order
        self.dgjumps = base.dgjumps
        self._device = base._device
        self._views = {}
        act = _arr(active)
        self.comp2base = np.nonzero(act)[0].astype(np.int32)
        self.base2comp = np.full(base.ndof, -1, dtype=np.int32)
        self.base2comp[self.comp2base] = np.arange(len(self.comp2base), dtype=np.int32)
        self.ndof = len(self.comp2base)
        # inactive dofs map to 0; assembly masks guarantee zero contributions
        mapped = self.base2comp[base.el2dof_np]
        self.el2dof_np = np.where(mapped >= 0, mapped, 0).astype(np.int32)
        # placeholder-0 slots are NOT dof 0; set algebra must skip them, and
        # so must the slots a masked base (SFESpace, XFESpace) leaves empty
        valid = mapped >= 0
        base_valid = getattr(base, "el2dof_valid_np", None)
        self.el2dof_valid_np = valid if base_valid is None else valid & base_valid
        self.dirichlet_dofs = base.dirichlet_dofs[self.comp2base]
        # optional base attributes: facet spaces (FacetFESpace/HDiv/SFESpace)
        # do not carry all of these; compress what exists
        for attr in ("bc_of_dof", "dof_rep_elem", "dof_rep_local",
                     "dof_rep_ref"):
            v = getattr(base, attr, None)
            if v is not None:
                setattr(self, attr, v[self.comp2base])
        # non-Lagrange bases (FacetFESpace, HDiv, SFESpace, XFESpace)
        # evaluate through the base's hook: its factor's local slot layout is
        # that of el2dof_np above
        hook = getattr(base, "proxy_factor_hook", None)
        if hook is not None:
            self.proxy_factor_hook = hook
            # the hook's values have the base's shape (HDiv: vectors)
            self.vdim = getattr(base, "vdim", 1)


def Compress(space: FESpace, active_dofs=None):
    if active_dofs is None:
        raise ValueError("Compress requires active_dofs")
    return CompressedFESpace(space, active_dofs)


@traced("GetDofsOfElements")
def GetDofsOfElements(space, elem_mask) -> BitArray:
    """Dofs touched by marked elements (cf. xfem/cutinfo.cpp:281-329); of
    every component for a vector space."""
    mask = _arr(elem_mask)
    vdim = space.vdim if isinstance(space, VectorFESpace) else 1
    out = np.zeros(space.ndof // vdim, dtype=bool)
    dofs = space.el2dof_np[mask]
    valid = getattr(space, "el2dof_valid_np", None)
    if valid is not None:  # placeholder-0 slots of a masked space
        out[dofs[valid[mask]]] = True
    else:
        out[dofs.ravel()] = True
    return BitArray(np.tile(out, vdim))


class PeriodicFESpace(FESpace):
    """Periodic identification of a space (NGSolve ``Periodic(fes)``).

    Unifies dofs across the mesh's periodic boundary pairs (built by
    ``MakeStructured*DMesh(periodic=...)``): a dof on a max-side periodic
    boundary maps to its translate on the min side.  Matching is geometric:
    each dof's representative node position is wrapped modulo the mesh
    bounding box along the periodic axes, which is exact on the structured
    unit-box meshes.  Only max-side dofs with exactly one min-side
    translate merge; a discontinuous space (every dof in one element) keeps
    all its dofs, since its periodicity is a facet identification.
    ``base2comp`` (base dof -> unified dof) and ``comp2base`` (its
    representative base dof) relate the two numberings."""

    def __init__(self, base: FESpace):
        self.base = base
        self.mesh = base.mesh
        self.order = base.order
        self.dgjumps = base.dgjumps
        self._device = base._device
        self._views = {}
        axes = getattr(base.mesh, "periodic_axes", "")
        if not axes:
            raise ValueError(
                "Periodic(space): the mesh has no periodic identification; "
                "build it with MakeStructured*DMesh(periodic=...)")
        verts = base.mesh.vertices_np
        elv = verts[base.mesh.elements_np[base.dof_rep_elem]]  # (nd, nvel, d)
        N = geom_shapes(base.mesh.et, base.dof_rep_ref)       # (nd, nvel)
        pos = np.einsum("nv,nvd->nd", N, elv)
        lo, hi = verts.min(0), verts.max(0)
        ext = hi - lo
        key = pos.copy()
        moved = np.zeros(len(pos), dtype=bool)
        for ax, ch in enumerate("xyz"[: verts.shape[1]]):
            if ch in axes:
                w = (pos[:, ax] - lo[ax]) / ext[ax]
                on_max = np.abs(w - 1.0) < 1e-12
                moved |= on_max
                key[:, ax] = lo[ax] + np.where(on_max, 0.0, w) * ext[ax]
        ikey = np.round(key * 2.0**38).astype(np.int64)
        vkey = np.ascontiguousarray(ikey).view(
            [("", ikey.dtype)] * ikey.shape[1]).ravel()
        rep = np.arange(len(pos))
        unm = np.nonzero(~moved)[0]
        if np.bincount(base.el2dof_np.ravel(),
                       minlength=base.ndof).max() <= 1:
            moved[:] = False
        if moved.any() and len(unm):
            uk, idx0, counts = np.unique(vkey[unm], return_index=True,
                                         return_counts=True)
            mi = np.nonzero(moved)[0]
            where = np.clip(np.searchsorted(uk, vkey[mi]), 0, len(uk) - 1)
            hit = (uk[where] == vkey[mi]) & (counts[where] == 1)
            rep[mi[hit]] = unm[idx0[where[hit]]]
        comp2base, inv = np.unique(rep, return_inverse=True)
        self.base2comp = inv.reshape(-1).astype(np.int32)
        self.comp2base = comp2base.astype(np.int32)
        self.ndof = len(comp2base)
        self.el2dof_np = self.base2comp[base.el2dof_np]
        # a unified dof is a Dirichlet / boundary dof if any of its base
        # dofs is one
        self.dirichlet_dofs = np.zeros(self.ndof, dtype=bool)
        np.logical_or.at(self.dirichlet_dofs, self.base2comp,
                         base.dirichlet_dofs)
        self.bc_of_dof = np.zeros(self.ndof, dtype=np.int32)
        np.maximum.at(self.bc_of_dof, self.base2comp, base.bc_of_dof)
        self.dof_rep_elem = base.dof_rep_elem[self.comp2base]
        self.dof_rep_local = base.dof_rep_local[self.comp2base]
        self.dof_rep_ref = base.dof_rep_ref[self.comp2base]


def Periodic(space):
    """The periodic identification of ``space`` (``PeriodicFESpace``)."""
    return PeriodicFESpace(space)
