"""The flagship's lattice DIA table on the card: one launch of a kernel.

``UnfittedPoisson.assemble_vals_lattice`` holds the one device branch: where
``takes`` holds (CUDA tensors of one float dtype, the 3D tet lattice at
order 1, no ``planes`` box, no gradient asked for) it calls ``assemble``,
which launches the kernel (``lattice_asm``; see the note at the top of its
source, no TPU counterpart: XLA fuses the reference's jnp code) and gives the
eager path's table bit for bit, signed zeros aside; everything else runs
the eager path, which stays the plain twin.

The kernel reads a plan (``plan_tables``): the eager path's own group lists
(``stencil_groups``, ``gp_lattice_types``) flattened into int tables, with
the cut tet's decomposition (``ops/cuttables._decompose``) and the P1
basis.  It is built and uploaded once per model, offset set and device; a
call then allocates the table and a zeroed count (one fill), launches once,
and reads nothing back.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import config
from ..kernels.launch import INT, PTR, Library, on_card

# offsets the kernel takes (csrc/lattice_asm.cu kMaxOff); the 3D lattice has 27
MAX_OFFSETS = 32

# launches of the CUDA kernel (one per `assemble` call)
launches = 0

# the order of the plan's header (csrc/lattice_asm.cu `Header`)
HEADER = ("n_off", "k0", "n_types", "elem_units", "elem_start",
          "corner_start", "vperm", "basis_start", "decomp_start", "gp_types",
          "gp_start")
PATTERN_INTS = 2 + 6 * 4 + 2 * 3   # csrc/lattice_asm.cu kPatternInts

_SIG = (PTR, PTR, PTR, PTR, PTR, INT, INT, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, PTR)
LIB = Library("lattice_asm", {torch.float32: ("lattice_asm_f32", _SIG),
                              torch.float64: ("lattice_asm_f64", _SIG)})


def takes(model, vertices, lset_vertex, planes=None):
    """Whether ``assemble_vals_lattice`` runs the kernel on these inputs:
    ``vertices`` and ``lset_vertex`` CUDA tensors of the model's lattice, of
    one dtype (float32 or float64) on one device, the 3D tet lattice at order
    1, no ``planes`` box, and no gradient asked for (grad mode on and an
    input that requires one).  Decided from the inputs alone."""
    n = (model.nx + 1) ** 3
    return (planes is None and model.dim == 3 and model.et == "tet"
            and model.order == 1
            and on_card(vertices) and on_card(lset_vertex)
            and vertices.device == lset_vertex.device
            and vertices.dtype in LIB.entries
            and lset_vertex.dtype == vertices.dtype
            and tuple(vertices.shape) == (n, 3)
            and tuple(lset_vertex.shape) == (n,)
            and not (torch.is_grad_enabled()
                     and (vertices.requires_grad
                          or lset_vertex.requires_grad)))


def _units(model, offsets):
    """Host: (element units, facet types) of the kernel's plan, from the
    eager path's cached group lists.  An element unit is a cube around a
    row's vertex, as its displacement ``dsp`` (the vertex's place in the
    cube; the cube is vertex - dsp) and the tets of the cube that hold the
    vertex: ``(dsp, [(t, i, [diagonal of entry j for j in 0..3])])``, t
    ascending, the units by ``dsp`` ascending.  Raises ``NotImplementedError``
    unless these units give every group of ``stencil_groups`` with its tets
    in their order, the order of the kernel's sums."""
    from .poisson import _disp

    offsets = np.asarray(offsets)
    nv1 = model.nx + 1
    if not hasattr(model, "_stencil_cache"):
        model._stencil_cache = model.stencil_groups(offsets)
    groups, S, _ = model._stencil_cache
    if not hasattr(model, "_gp_lattice_cache"):
        model._gp_lattice_cache = model.gp_lattice_types(offsets)
    p = np.asarray(model.p1dof2vertex, dtype=np.int64)
    D = p[model.space.el2dof_np[:S]]    # (S, 4) rows of cube 0, Lagrange order
    units = {}
    for t in range(S):
        for i in range(D.shape[1]):
            ks = [int(np.searchsorted(offsets, int(D[t, j] - D[t, i])))
                  for j in range(D.shape[1])]
            dsp = _disp(int(D[t, i]), 3, nv1)
            units.setdefault(dsp, []).append((t, i, ks))
    again = {}
    for dsp, vis in units.items():
        for t, i, ks in vis:
            for j, k in enumerate(ks):
                again.setdefault((k, dsp), []).append((t, i, j))
    if again != groups:
        raise NotImplementedError("the lattice plan does not give the "
                                  "stencil groups in their order")
    return sorted(units.items()), model._gp_lattice_cache, D


def plan_tables(model, offsets):
    """Host: the kernel's plan as one int32 array (``HEADER``, then the
    sections it points to): the element units (``_units``: per cube its
    ``dsp``, its visits and the distinct diagonals they touch), the corner
    displacements of the tet types in element-corner order, the corner ->
    Lagrange node map, the P1 basis (b0, G, R of ``_p1_affine_basis``), per
    sign pattern of a tet its NEG sub-tets and interface triangles (specs
    ``a * 4 + b``), and per facet type of ``gp_lattice_types`` (its order)
    the units of a vertex's positions in the patch, ``dsp`` ascending, each
    with its terms ``i | j << 4 | k << 8`` by diagonal k and then in the
    group's order."""
    from ..integrate import vertex_local_ids
    from ..ops.cuttables import _decompose
    from .poisson import _disp, _p1_affine_basis

    offsets = np.asarray(offsets)
    if not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"{len(offsets)} offsets; the lattice_asm kernel "
                         f"takes 1 to {MAX_OFFSETS}")
    nv1 = model.nx + 1
    units, gp_types, D = _units(model, offsets)
    S = D.shape[0]
    vperm = [int(v) for v in vertex_local_ids("tet", 1)]
    head = dict.fromkeys(HEADER, 0)
    head.update(n_off=len(offsets), k0=int(np.searchsorted(offsets, 0)),
                n_types=S, elem_units=len(units), gp_types=len(gp_types))
    out = [0] * len(HEADER)

    head["elem_start"] = len(out)
    for dsp, vis in units:
        ks = sorted({k for _, _, kk in vis for k in kk})
        out += [*dsp, len(vis), len(ks), *ks]
        for t, i, kk in vis:
            out += [t, i, *kk]

    head["corner_start"] = len(out)
    for t in range(S):
        for c in range(4):
            out += list(_disp(int(D[t, vperm[c]]), 3, nv1))
    head["vperm"] = len(out)
    out += vperm

    head["basis_start"] = len(out)
    b0, G, R = _p1_affine_basis("tet")
    for a in (b0, G, R):
        a = np.asarray(a).reshape(-1)
        if not np.array_equal(a, np.round(a)):
            raise NotImplementedError("the P1 basis tables are not integers")
        out += [int(v) for v in np.round(a)]

    head["decomp_start"] = len(out)
    for pat in range(16):
        rec = [0] * PATTERN_INTS
        if 0 < pat < 15:
            subs, sides, ifs = _decompose(3, pat)
            neg = [sub for sub, side in zip(subs, sides) if side == 0]
            rec[0], rec[1] = len(neg), len(ifs)
            for s, sub in enumerate(neg):
                rec[2 + 4 * s:6 + 4 * s] = [a * 4 + b for a, b in sub]
            for f, tri in enumerate(ifs):
                rec[26 + 3 * f:29 + 3 * f] = [a * 4 + b for a, b in tri]
        out += rec

    head["gp_start"] = len(out)
    for ta, tb, dlt, ggroups in gp_types:
        dsps = sorted({dsp for _, dsp in ggroups})
        out += [ta, tb, *dlt, len(dsps)]
        for dsp in dsps:
            terms = [i | j << 4 | k << 8
                     for (k, g), ijs in sorted(ggroups.items()) if g == dsp
                     for i, j in ijs]
            out += [*dsp, len(terms), *terms]

    out[:len(HEADER)] = [head[h] for h in HEADER]
    return np.asarray(out, dtype=np.int32)


class _Plan:
    """The plan's host and device tables."""

    def __init__(self, tables, device):
        self.host = tables
        self.n_off = int(tables[0])
        self.tables = torch.as_tensor(tables, device=device)


def plan(model, offsets, device):
    """The model's plan for ``offsets`` on ``device``, built and uploaded
    once."""
    cache = model.__dict__.setdefault("_lattice_asm_plans", {})
    key = (np.asarray(offsets, dtype=np.int64).tobytes(), str(device))
    hit = cache.get(key)
    if hit is None:
        hit = cache[key] = _Plan(plan_tables(model, offsets), device)
    return hit


def assemble(model, vertices, lset_vertex, offsets):
    """(V (n_off, n), ncut) of ``assemble_vals_lattice`` on inputs that
    ``takes``: a fill of the count and one launch on the current stream,
    nothing read back."""
    global launches
    pl = plan(model, offsets, vertices.device)
    X = vertices.contiguous()
    L = lset_vertex.contiguous()
    V = torch.empty((pl.n_off, X.shape[0]), dtype=X.dtype, device=X.device)
    ncut = torch.zeros((), dtype=torch.int64, device=X.device)
    LIB.launch(X.dtype, X, X.data_ptr(), L.data_ptr(), V.data_ptr(),
               ncut.data_ptr(), pl.tables.data_ptr(),
               len(pl.host), model.nx, float(config.lset_eps),
               float(model.lam_nitsche), float(model.gamma_gp))
    launches += 1
    return V, ncut
