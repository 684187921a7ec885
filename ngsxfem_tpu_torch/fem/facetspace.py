"""FacetFESpace: facet-wise discontinuous Lagrange space.

Counterpart of ``ngsxfem_tpu/fem/facetspace.py``: NGSolve's facet-variable
space as the reference's HDG cut formulations use it
(``tests/pytests/test_straightcutrule.py:313-331``: ``FacetFESpace`` +
``GetDofsOfFacets`` + ``element_boundary=True``).  Dofs live per facet; an
element sees the dofs of all its facets, and a basis function is a
facet-Lagrange polynomial supported on one facet only.

At element-reference points that lie on a facet (the rows of element-
boundary and skeleton contexts), the basis factor is the facet-Lagrange
shape at the facet's parametric coordinate, zero off the facet.  The
parametrization is anchored at the global facet vertex order, so the two
elements sharing a facet see the same global basis functions.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ..mesh.mesh import FACET_ET
from .basis import ndof_el, shapes
from .space import FESpace, BitArray, CompressedFESpace, L2, _arr


class FacetFESpace(FESpace):
    """Facet-wise polynomials of given order (cf. NGSolve FacetFESpace)."""

    def __init__(self, mesh, order: int = 0, dirichlet=None, device=None,
                 **kw):
        fet = FACET_ET[mesh.et]
        if fet == "point":
            raise NotImplementedError("FacetFESpace on 1D meshes")
        self.facet_et = fet
        super().__init__(mesh, order=order, dirichlet=dirichlet,
                         device=device)

    def _build(self):
        m = self.mesh
        self.ndof_facet = ndof_el(self.facet_et, self.order)
        self.ndof = m.nfacets * self.ndof_facet
        self.facet2dof_np = np.arange(self.ndof, dtype=np.int32).reshape(
            m.nfacets, self.ndof_facet)
        # element dofs: all facets' dofs, ordered by local facet
        self.el2dof_np = self.facet2dof_np[m.el2facet_np].reshape(m.ne, -1)
        self._build_facet_frames()

    @property
    def ndof_el(self):
        return self.el2dof_np.shape[1]

    def _build_facet_frames(self):
        """Per (element, local facet): the affine inverse parametrization
        s = A (p - V0) of the facet plane in element-reference coordinates,
        anchored at the global facet vertex order (host)."""
        from ..ops.cuttables import REF_VERTS

        m = self.mesh
        refv = REF_VERTS[m.et]
        gfacets = m.facets_np[m.el2facet_np]  # (ne, nfel, nvf) canonical
        els = m.elements_np
        # local index of each canonical facet vertex within the element
        loc_idx = np.argmax(els[:, None, None, :] == gfacets[..., None],
                            axis=-1)
        loc_ref = refv[loc_idx]  # (ne, nfel, nvf, d)
        V0 = loc_ref[..., 0, :]
        E = loc_ref[..., 1:, :] - V0[..., None, :]
        if self.facet_et == "quad":  # parameter axes: edges 0->1 and 0->3
            E = np.stack([loc_ref[..., 1, :] - V0, loc_ref[..., 3, :] - V0],
                         axis=-2)
        # pseudo-inverse rows: s = (E E^T)^-1 E (p - V0)
        G = np.einsum("efkd,efld->efkl", E, E)
        self._A_np = np.einsum("efkl,efld->efkd", np.linalg.inv(G), E)
        self._V0_np = V0
        self._E_np = E

    def _mark_boundary_dofs(self):
        m = self.mesh
        self.bc_of_dof = np.zeros(self.ndof, dtype=np.int32)
        bf = m.boundary_facets_np
        self.bc_of_dof[self.facet2dof_np[bf].ravel()] = np.repeat(
            m.bc_of_facet_np[bf], self.ndof_facet)

    def _dirichlet_mask(self, dirichlet):
        """Dofs of the boundary facets whose id the spec names (regex over
        the boundary names, or an id list)."""
        m = self.mesh
        diri = np.zeros(self.ndof, dtype=bool)
        if dirichlet:
            if isinstance(dirichlet, str):
                pat = re.compile(dirichlet)
                ids = {bid for bid, name in m.bc_names.items()
                       if pat.fullmatch(name)}
            else:
                ids = set(int(b) for b in dirichlet)
            for f in m.boundary_facets_np:
                if int(m.bc_of_facet_np[f]) in ids:
                    diri[self.facet2dof_np[f]] = True
        return diri

    def _frames(self, device, dtype):
        return tuple(self._view(name, host, dtype, device) for name, host in
                     (("facet_A", self._A_np), ("facet_V0", self._V0_np),
                      ("facet_E", self._E_np)))

    def proxy_factor_hook(self, proxy, ctx, pctx):
        from ..forms.evaluate import Factor

        if proxy.op != "val":
            raise NotImplementedError(
                f"FacetFESpace supports the value operator only "
                f"(op={proxy.op})")
        pts = pctx.ref_pts  # (E|1, Q, d)
        A, V0, E = self._frames(pts.device, pts.dtype)
        eids = pctx.elem_ids
        if eids is not None:
            A, V0, E = A[eids], V0[eids], E[eids]
        rel = pts[:, :, None, :] - V0[:, None, :, :]  # (E,Q,nfel,d)
        # "efkd,eqfd->eqfk"
        s = (A[:, None] * rel[:, :, :, None, :]).sum(-1)  # (E,Q,nfel,d-1)
        # on-facet test: reconstruction residual of the affine frame
        rec = (s[..., None] * E[:, None]).sum(-2)  # "eqfk,efkd->eqfd"
        res = torch.linalg.vector_norm(rel - rec, dim=-1)  # (E,Q,nfel)
        # tolerance scaled by the dtype eps (an absolute 1e-9 is below f32
        # roundoff: the whole facet basis would mask to zero)
        tol = max(1e3 * torch.finfo(pts.dtype).eps, 1e-9)
        inside = ((s > -tol) & (s < 1 + tol)).all(-1)
        if self.facet_et == "trig":
            inside = inside & (s.sum(-1) < 1 + tol)
        on = (res < tol) & inside
        Eb, Q, nfel = s.shape[:3]
        Sf = shapes(self.facet_et, self.order,
                    s.reshape(Eb, Q * nfel, -1)).reshape(
            Eb, Q, nfel, self.ndof_facet)
        arr = torch.where(on[..., None], Sf, 0.0).reshape(
            Eb, Q, nfel * self.ndof_facet)
        return Factor(block=proxy.block_key, arr=arr, space=proxy.space)


def GetDofsOfFacets(space, facet_mask) -> BitArray:
    """Dofs associated with marked facets (reference
    ``xfem/cutinfo.cpp:306-329``: GetDofNrs per NT_FACET node).

    A FacetFESpace marks all dofs of the facet; continuous element spaces
    (H1) mark the facet-interior Lagrange dofs (the NT_FACET node dofs,
    none for order 1 on simplices, as in NGSolve); L2 spaces have no facet
    dofs; a ``Compress``ed space marks those of its base it keeps.
    """
    from .basis import facet_local_nodes

    mask = _arr(facet_mask)
    if isinstance(space, CompressedFESpace):
        inner = GetDofsOfFacets(space.base, mask)
        return BitArray(inner.np[space.comp2base])
    out = np.zeros(space.ndof, dtype=bool)
    if isinstance(space, FacetFESpace):
        out[space.facet2dof_np[mask].ravel()] = True
        return BitArray(out)
    if isinstance(space, L2):
        return BitArray(out)  # all dofs are element-interior
    lfn = facet_local_nodes(space.mesh.et, space.order, interior_only=True)
    m = space.mesh
    fids = np.nonzero(mask)[0]
    e = m.facet2el_np[fids, 0]
    lf = m.facet2elloc_np[fids, 0]
    for loc, ids in enumerate(lfn):
        sel = lf == loc
        if len(ids) and sel.any():
            out[space.el2dof_np[e[sel]][:, ids].ravel()] = True
    return BitArray(out)
