"""Mixed-element-type (quad-dominated) meshes as composites.

Counterpart of ``ngsxfem_tpu/mesh/composite.py``.  The reference supports
Netgen's ``quad_dominated=True`` meshes: mixed trig+quad element sets (e.g.
``tests/pytests/test_backuprule.py:15``, ``py_tutorials/cutfem.py:82-85``).
A ``Mesh`` holds one element type (one static shape per kernel family), so a
mixed mesh is a COMPOSITE: one shared vertex array, one ``Mesh`` per element
type, and vertex-indexed global P1 dofs gluing the groups together.  Cut
quadrature, classification and H1(order=1) assembly all run per group with
the group-native kernels (simplex case tables vs multilinear tensor rules)
and reduce into the shared dof numbering.

Covered surface: ``CompositeGridFunction`` (+`Set`), ``IntegrateC``
(NEG/POS/IF), ``CompositeCutInfo``, ``CompositeBilinearForm``/
``CompositeLinearForm`` building each group's form from a user callback —
enough for unfitted interface/fictitious-domain solves on quad-dominated
meshes.  Higher-order composite spaces and cross-type facet algebra are out
of scope (per-group facets only).  Vectors are tensors on the device of
the ``CompositeGridFunction`` (the card unless the caller asks for the
CPU); the per-group load vectors are summed into the shared dofs through a
``ScatterPlan``, in a fixed order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import config, resolve_device


class CompositeMesh:
    """Shared-vertex collection of single-type meshes (one per element type).

    groups: list of (et, elements (ne_g, nvel_g)) over ONE vertex array.
    """

    def __init__(self, vertices, groups):
        self.vertices_np = np.asarray(vertices, dtype=np.float64)
        self.nv = len(self.vertices_np)
        from .io import MeshFromArrays

        self.submeshes = [MeshFromArrays(et, self.vertices_np, els)
                          for et, els in groups]
        self.dim = self.submeshes[0].dim
        self.ne = sum(m.ne for m in self.submeshes)

    def __repr__(self):
        parts = ", ".join(f"{m.et}:{m.ne}" for m in self.submeshes)
        return f"CompositeMesh(nv={self.nv}, {parts})"


def MakeQuadDominated2DMesh(nx=10, ny=10, mapping=None, trig_band=0.4):
    """Structured quad-dominated unit-square mesh: cells with center-x below
    ``trig_band`` split into triangles, the rest stay quads — a genuinely
    mixed trig+quad mesh (the moral analog of Netgen's quad_dominated)."""
    xs = np.linspace(0.0, 1.0, nx + 1)
    ys = np.linspace(0.0, 1.0, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    unit = np.stack([X.ravel(), Y.ravel()], axis=1)
    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()
    v00 = I * (ny + 1) + J
    v10 = (I + 1) * (ny + 1) + J
    v11 = (I + 1) * (ny + 1) + J + 1
    v01 = I * (ny + 1) + J + 1
    cx = (xs[I] + xs[I + 1]) / 2
    as_trig = cx < trig_band
    cells = np.stack([v00, v10, v11, v01], axis=1)
    quads = cells[~as_trig].astype(np.int32)
    qt = cells[as_trig]
    trigs = np.concatenate([qt[:, [0, 1, 2]], qt[:, [0, 2, 3]]], axis=0
                           ).astype(np.int32)
    verts = unit.copy()
    if mapping is not None:
        verts = np.array([mapping(a, b) for a, b in unit], dtype=np.float64)
    groups = []
    if len(quads):
        groups.append(("quad", quads))
    if len(trigs):
        groups.append(("trig", trigs))
    return CompositeMesh(verts, groups)


class CompositeGridFunction:
    """P1 scalar field on a CompositeMesh: one vertex-indexed global vector
    on ``device`` (the card unless the caller asks for the CPU), viewed per
    group through that group's H1(order=1) dof maps.  Groups may reference
    only a subset of the shared vertices."""

    def __init__(self, cmesh: CompositeMesh, device=None):
        from ..fem.space import H1
        from ..fem.gridfunction import GridFunction
        from ..integrate import _p1_vertex_dofs

        self.cmesh = cmesh
        self.device = resolve_device(device)
        self.spaces = [H1(m, order=1, device=self.device)
                       for m in cmesh.submeshes]
        self.gfs = [GridFunction(sp) for sp in self.spaces]
        self.v2d = []  # vertex -> group dof (only valid on referenced verts)
        self.d2v = []  # group dof -> vertex
        for m, sp in zip(cmesh.submeshes, self.spaces):
            v2d = np.asarray(_p1_vertex_dofs(sp))
            ref = np.zeros(cmesh.nv, dtype=bool)
            ref[m.elements_np] = True
            d2v = np.zeros(sp.ndof, dtype=np.int64)
            d2v[v2d[ref]] = np.nonzero(ref)[0]
            self.v2d.append(v2d)
            self.d2v.append(d2v)
        self._vec = torch.zeros((cmesh.nv,), dtype=config.dtype,
                                device=self.device)

    @property
    def vec(self):
        return self._vec

    def set_values(self, vertex_values):
        self._vec = torch.as_tensor(vertex_values, dtype=config.dtype,
                                    device=self.device)
        for gf, d2v in zip(self.gfs, self.d2v):
            gf._set_array(self._vec[torch.as_tensor(d2v, device=self.device)])
        return self

    def Set(self, cf):
        """Vertex interpolation of a CF (InterpolateToP1 analog)."""
        from ..fem.gridfunction import InterpolateToP1

        glob = np.zeros(self.cmesh.nv)
        seen = np.zeros(self.cmesh.nv, dtype=bool)
        for k, (m, gf) in enumerate(zip(self.cmesh.submeshes, self.gfs)):
            InterpolateToP1(cf, gf)
            sub = gf._arr.detach().cpu().numpy()
            ref = np.zeros(self.cmesh.nv, dtype=bool)
            ref[m.elements_np] = True
            vids = np.nonzero(ref)[0]
            glob[vids] = sub[self.v2d[k][vids]]
            seen |= ref
        assert seen.all(), "composite groups do not cover all vertices"
        return self.set_values(glob)


def IntegrateC(levelset_domain, cf, cmesh: CompositeMesh, order=5,
               device=None):
    """Integrate over a CompositeMesh: per-group cut integration with the
    group-native rules, summed in group order (None levelset_domain =
    plain volume).  Runs where ``Integrate`` runs: on the level set's
    device, else on ``device``."""
    from ..integrate import Integrate

    total = 0.0
    lset = (levelset_domain or {}).get("levelset")
    for k, m in enumerate(cmesh.submeshes):
        ld = None
        if levelset_domain is not None:
            ld = dict(levelset_domain)
            if isinstance(lset, CompositeGridFunction):
                ld["levelset"] = lset.gfs[k]
        total += Integrate(ld, cf=cf, mesh=m, order=order, device=device)
    return total


class CompositeCutInfo:
    """Per-group CutInfo with group-concatenated element queries."""

    def __init__(self, cmesh: CompositeMesh, lset: CompositeGridFunction):
        from ..geom.cutinfo import CutInfo

        self.cis = [CutInfo(m, gf, device=lset.device)
                    for m, gf in zip(cmesh.submeshes, lset.gfs)]

    def GetElementsOfType(self, dt, VOL_or_BND=None):
        from ..fem.space import BitArray
        from ..geom.cutinfo import VOL

        vb = VOL if VOL_or_BND is None else VOL_or_BND
        parts = [np.asarray(ci.GetElementsOfType(dt, vb).np)
                 for ci in self.cis]
        return BitArray(np.concatenate(parts))

    def per_group(self, dt):
        return [ci.GetElementsOfType(dt) for ci in self.cis]


class CompositeBilinearForm:
    """Assemble one bilinear form per group (via ``make(space, group_index)``
    returning that group's BilinearForm) and reduce into the shared
    vertex-indexed global dofs: the groups' COO triplets, concatenated (the
    ELL view, ``a.mat.ell()``, sums them on the host, in a fixed order)."""

    def __init__(self, cgf_space: CompositeGridFunction, make):
        self.cspace = cgf_space
        self.make = make
        self.mat = None

    def Assemble(self):
        from ..solvers.sparse import SparseMatrix

        rows, cols, vals = [], [], []
        nv = self.cspace.cmesh.nv
        for k, sp in enumerate(self.cspace.spaces):
            a = self.make(sp, k)
            a.Assemble()
            m = a.mat
            d2v = self.cspace.d2v[k]
            rows.append(d2v[m.rows.cpu().numpy()])
            cols.append(d2v[m.cols.cpu().numpy()])
            vals.append(m.vals)
        self.mat = SparseMatrix(
            np.concatenate(rows), np.concatenate(cols), torch.cat(vals),
            (nv, nv), device=self.cspace.device)
        return self


class CompositeLinearForm:
    """Assemble one linear form per group (``make(space, group_index)``)
    and sum them into the shared vertex-indexed dofs in group order, through
    a ``ScatterPlan`` (the same bits on every run and device)."""

    def __init__(self, cgf_space: CompositeGridFunction, make):
        self.cspace = cgf_space
        self.make = make
        self._vec = None
        self._plan = None

    @property
    def vec(self):
        from ..fem.gridfunction import StandaloneVec

        return StandaloneVec(self._vec)

    def Assemble(self):
        from ..ops.scatter import ScatterPlan

        dev = self.cspace.device
        parts = []
        for k, sp in enumerate(self.cspace.spaces):
            f = self.make(sp, k)
            f.Assemble()
            parts.append(f._vec)
        if self._plan is None:
            index = torch.as_tensor(np.concatenate(self.cspace.d2v),
                                    device=dev)
            self._plan = ScatterPlan(index, self.cspace.cmesh.nv)
        self._vec = self._plan.add(torch.cat(parts))
        return self
