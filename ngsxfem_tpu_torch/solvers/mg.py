"""Cut geometric multigrid: prolongations, patch-block and interface
smoothing, the V-cycle over a space hierarchy and its functional ELL form.

Counterpart of ``ngsxfem_tpu/solvers/mg.py``: the nodal prolongation
(coarse basis evaluated at fine dof nodes, any order, simplices and
multilinear quads/hexes), the patch builders ``VertPatches`` /
``ElemPatches`` / ``EdgePatches``, ``CutFemSmoother`` (damped Jacobi or
patch-block additive Schwarz, plus an inner CG on the interface dof block),
``MultiGridCL`` (the V-cycle of the reference's ``python/cutmg.py:17-111``),
the prolongation classes, ``P2TwoGridCL``, ``LinearMGIterator`` and
``FunctionalELLMG`` with its host COO/ELL tables.  Host setup is numpy; the
patch-block inverses are built batched on the matrix's device
(``_prepare_blocks``).  Every sparse product of a cycle (level operator,
restriction, prolongation, interface block, smoother residual) goes
through an ELL view, ``ell_spmv.ell_matvec``, the hand-written ELL kernel
on the card, its layout built once when the solver is set up.  Block
smoothing sums through a fixed-order ``ScatterPlan``, so two runs give the
same bits.  ``FunctionalELLMG``'s coarse solve is a dense ``torch.matmul``
with the host-computed inverse (``prepare_host``) or a Cholesky solve
(``prepare``); ``MultiGridCL`` factors its coarse free block on the host in
f64 and solves with ``torch.cholesky_solve`` / ``torch.linalg.lu_solve``.
float32 products run in full float32 (``config.py`` turns TF32 off).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import as_input, config, resolve_device, torch_dtype
from ..fem.space import _arr as _bits
from ..ops.scatter import ScatterPlan
from .krylov import cg, masked_matvec
from .sparse import ELLMatrix, SparseMatrix


def mesh_hierarchy(make_mesh, nx0: int, levels: int):
    """Meshes [coarse..fine] from a structured generator make_mesh(nx)."""
    return [make_mesh(nx0 * 2**l) for l in range(levels)]


def _prolongation_coo(coarse_space, fine_space):
    """Host COO (rows, cols, vals f64, shape) of P: coarse dofs -> fine dofs,
    by coarse-basis evaluation at the fine dof nodes."""
    from ..fem.basis import shapes, lagrange_element
    from ..mesh.mesh import geom_shapes
    from scipy.spatial import cKDTree

    cm, fm = coarse_space.mesh, fine_space.mesh
    # fine dof node physical coords
    b = lagrange_element(fm.et, fine_space.order)
    N = geom_shapes(fm.et, b["nodes"])  # (ndl, nv)
    fnodes = np.einsum("lv,evd->eld", N, fm.vertices_np[fm.elements_np])
    pts = np.zeros((fine_space.ndof, fm.dim))
    fflat = fine_space.el2dof_np.reshape(-1)
    fnflat = fnodes.reshape(-1, fm.dim)
    fvalid = getattr(fine_space, "el2dof_valid_np", None)
    if fvalid is not None:  # masked spaces (Compress, XFESpace, SFESpace)
        fv = fvalid.reshape(-1)  # point inactive slots at dof 0: drop them,
        fflat, fnflat = fflat[fv], fnflat[fv]  # else dof 0 gets their node
    pts[fflat] = fnflat

    # locate each fine node in a coarse element: kd-tree over coarse element
    # centroids + vectorized membership test over the k nearest candidates
    cverts = cm.vertices_np[cm.elements_np]  # (nec, nv, d)
    tree = cKDTree(cverts.mean(axis=1))
    k = int(min(cm.ne, 16))
    _, cand = tree.query(pts, k=k)
    cand = cand.reshape(len(pts), k)
    owner = np.full(fine_space.ndof, -1, dtype=np.int64)
    for j in range(k):
        un = np.nonzero(owner < 0)[0]
        if len(un) == 0:
            break
        e = cand[un, j]
        loc = _invert_geom_pp(cm.et, cverts[e], pts[un])
        ok = np.all((loc > -1e-8) & (loc < 1 + 1e-8), axis=1)
        if cm.et in ("trig", "tet"):
            ok &= loc.sum(axis=1) < 1 + 1e-8
        owner[un[ok]] = e[ok]
    if (owner < 0).any():
        raise RuntimeError("prolongation: fine node outside coarse mesh")

    locs = _invert_geom_pp(cm.et, cverts[owner], pts)
    # coarse basis values at the fine nodes
    B = shapes(cm.et, coarse_space.order, locs[:, None, :])[:, 0]
    cdofs = coarse_space.el2dof_np[owner]  # (nf, ndl)
    rows = np.repeat(np.arange(fine_space.ndof), cdofs.shape[1])
    cols = cdofs.reshape(-1)
    vals = B.reshape(-1)
    cvalid = getattr(coarse_space, "el2dof_valid_np", None)
    if cvalid is not None:  # no weight of an inactive slot into dof 0
        vals = np.where(cvalid[owner].reshape(-1), vals, 0.0)
    keep = np.abs(vals) > 1e-12
    return (rows[keep], cols[keep], vals[keep],
            (fine_space.ndof, coarse_space.ndof))


def prolongation_matrix(coarse_space, fine_space, dtype=None, *,
                        device=None) -> SparseMatrix:
    """P: coarse dofs -> fine dofs as a ``SparseMatrix`` of ``dtype``
    (default ``config.dtype``) on ``device`` (the card unless the caller
    asks for the CPU).  Nested structured meshes of any (equal) order; the
    analog of P1Prolongation/P2Prolongation
    (utils/xprolongation.hpp:13-101)."""
    rows, cols, vals, shape = _prolongation_coo(coarse_space, fine_space)
    dtype = torch_dtype(dtype) or config.dtype
    return SparseMatrix(rows, cols, torch.as_tensor(vals, dtype=dtype), shape,
                        device=device)


def _invert_geom_pp(et, verts, pts):
    """Local coords of physical pts, per-point element vertices (host
    numpy).

    verts (N, nvel, d), pts (N, d) -> (N, d).  Affine exact for simplices;
    20 batched Newton steps from the element centre for multilinear
    quads/hexes.
    """
    from ..mesh.mesh import geom_dshapes, geom_shapes

    d = pts.shape[1]
    v0 = verts[:, 0]
    if et in ("trig", "tet", "segm"):
        E = np.swapaxes(verts[:, 1:d + 1] - v0[:, None], 1, 2)  # (N, d, d)
        return np.linalg.solve(E, (pts - v0)[..., None])[..., 0]
    loc = np.full_like(pts, 0.5)
    for _ in range(20):
        N = geom_shapes(et, loc[:, None, :])[:, 0]  # (N, nvel)
        dN = geom_dshapes(et, torch.from_numpy(loc[:, None, :]))[:, 0].numpy()
        cur = np.einsum("nv,nvd->nd", N, verts)
        J = np.einsum("nvd,nvg->ndg", dN, verts)  # dx_g / dloc_d
        loc = loc + np.linalg.solve(
            np.swapaxes(J, 1, 2), (pts - cur)[..., None])[..., 0]
    return loc


def _ell_view(M):
    """The ELL view through which a level operator or transfer applies:
    ``SparseMatrix.ell()`` (its layout built here, once), the last matrix of
    a ``P1Prolongation``, or ``M`` itself (an object with its own
    ``matvec``, e.g. a ``CompoundProlongation``)."""
    if isinstance(M, P1Prolongation):
        M = M.mats[-1]
    if isinstance(M, SparseMatrix):
        E = M.ell()
        E.layout()
        return E
    return M


def _ell_view_T(M):
    """The ELL view of the transpose of ``M`` (``P.T``, the restriction),
    cached on ``M``."""
    if isinstance(M, P1Prolongation):
        M = M.mats[-1]
    if isinstance(M, SparseMatrix):
        E = getattr(M, "_ell_T", None)
        if E is None:
            E = M._ell_T = M.CreateTranspose().ell()
        E.layout()
        return E
    return M.T


def _patch_blocks(keys, dofs, nkeys, free):
    """Blocks of the (key, dof) pairs: for each key in [0, nkeys), its
    distinct dofs >= 0 that are free, ascending (what ``np.unique`` per key
    gives), as a list of numpy arrays."""
    keys = np.asarray(keys, dtype=np.int64).reshape(-1)
    dofs = np.asarray(dofs).reshape(-1)
    ok = dofs >= 0
    ok[ok] = free[dofs[ok]]
    keys, dofs = keys[ok], dofs[ok]
    span = np.int64(max(int(dofs.max()) + 1, 1) if dofs.size else 1)
    pair = np.unique(keys * span + dofs)
    k, d = pair // span, (pair % span).astype(dofs.dtype)
    return np.split(d, np.searchsorted(k, np.arange(1, nkeys)))


def VertPatches(fes, mesh=None):
    """Vertex-patch dof blocks (cutmg.py:221-232): for each mesh vertex, the
    free dofs of all elements containing it."""
    mesh = mesh if mesh is not None else fes.mesh
    free = _bits(fes.FreeDofs())
    eldofs = fes.el2dof_np
    nvel = mesh.elements_np.shape[1]
    keys = np.repeat(mesh.elements_np, eldofs.shape[1], axis=1)
    dofs = np.tile(eldofs, (1, nvel))
    return _patch_blocks(keys, dofs, mesh.nv, free)


def ElemPatches(fes):
    """Element-patch dof blocks (cutmg.py:234-240)."""
    free = _bits(fes.FreeDofs())
    eldofs = fes.el2dof_np
    keys = np.repeat(np.arange(eldofs.shape[0]), eldofs.shape[1])
    return _patch_blocks(keys, eldofs, eldofs.shape[0], free)


def EdgePatches(fes, mesh=None):
    """Edge-patch dof blocks (cutmg.py:242-261): for each mesh edge, the
    free dofs of the elements sharing it, edges in ascending order of their
    sorted vertex pairs."""
    mesh = mesh if mesh is not None else fes.mesh
    free = _bits(fes.FreeDofs())
    from ..mesh.mesh import EDGE_VERTS

    ed = np.asarray(EDGE_VERTS[mesh.et])  # (nedg_local, 2) local vertex pairs
    pairs = np.sort(mesh.elements_np[:, ed], axis=2).reshape(-1, 2)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    eldofs = fes.el2dof_np
    keys = np.repeat(inv.reshape(-1), eldofs.shape[1])
    dofs = np.repeat(eldofs, ed.shape[0], axis=0)
    return _patch_blocks(keys, dofs, len(uniq), free)


def _prepare_blocks(A: SparseMatrix, blocks, free, stats=None):
    """Setup of patch-block smoothing, batched on the matrix's device:
    blocks padded to the largest size K, every dense sub-block of A
    extracted at once from its ELL view, symmetrized and inverted in f64 by
    one batched ``torch.linalg.inv_ex`` (``torch.linalg.pinv`` for the
    blocks it flags singular, the reference's fallback).

    Returns (idx (nb,K) int64, inv (nb,K,K) of A's dtype, valid (nb,K) bool,
    scale (n,)) with padded lanes pointing at dof 0 but masked out of both
    gather and scatter; ``scale`` is 1/#patches per dof, the overlap
    scaling of additive Schwarz.  None if no block keeps a free dof.
    ``stats`` (a dict), if given, receives nb, K and the number of blocks
    that needed ``pinv``."""
    lens = np.fromiter((len(b) for b in blocks), dtype=np.int64,
                       count=len(blocks))
    flat = (np.concatenate([np.asarray(b, dtype=np.int64).reshape(-1)
                            for b in blocks]) if lens.sum() else
            np.zeros(0, np.int64))
    bid = np.repeat(np.arange(len(blocks)), lens)
    order = np.lexsort((flat, bid))  # each block sorted
    flat, bid = flat[order], bid[order]
    keep = free[flat]
    flat, bid = flat[keep], bid[keep]
    if flat.size == 0:
        return None
    _, bid = np.unique(bid, return_inverse=True)  # drop emptied blocks
    counts = np.bincount(bid)
    nb, K = len(counts), int(counts.max())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(flat.size) - starts[bid]
    idx_np = np.zeros((nb, K), dtype=np.int64)
    valid_np = np.zeros((nb, K), dtype=bool)
    idx_np[bid, pos] = flat
    valid_np[bid, pos] = True

    E = A.ell()
    dev, dt = E.vals.device, E.vals.dtype
    n = A.shape[0]
    idx = torch.as_tensor(idx_np, device=dev)
    valid = torch.as_tensor(valid_np, device=dev)
    # dense sub-blocks: row a of block i is A's ELL row idx[i, a]; its
    # entries land at the block column whose dof equals theirs (rows of idx
    # are ascending; padded lanes search as n, never a column)
    srt = torch.where(valid, idx, n)
    C = E.cols.long()[idx]  # (nb, K, Kell)
    V = torch.where(valid[..., None], E.vals[idx], 0.0).to(torch.float64)
    Kell = C.shape[2]
    p = torch.searchsorted(srt, C.reshape(nb, K * Kell)).reshape(nb, K, Kell)
    p = p.clamp(max=K - 1)
    hit = torch.gather(srt, 1, p.reshape(nb, -1)).reshape(p.shape) == C
    flat_pos = (torch.arange(K, device=dev)[None, :, None] * K + p)
    Ab = torch.zeros((nb, K * K), dtype=torch.float64, device=dev)
    Ab.scatter_add_(1, flat_pos.reshape(nb, -1),
                    torch.where(hit, V, 0.0).reshape(nb, -1))
    Ab = Ab.reshape(nb, K, K)
    Ab = 0.5 * (Ab + Ab.transpose(1, 2))
    pad = ~valid  # inverted with the identity on the padding
    inv, info = torch.linalg.inv_ex(Ab + torch.diag_embed(pad.to(Ab.dtype)))
    bad = torch.nonzero(info != 0).reshape(-1)
    if bad.numel():  # numpy's default cut-off, as the reference's pinv
        inv[bad] = torch.linalg.pinv(Ab[bad], rtol=1e-15)
    both = valid[:, :, None] & valid[:, None, :]
    inv = torch.where(both, inv, 0.0).to(dt)
    if stats is not None:
        stats.update(nb=nb, K=K, pinv=int(bad.numel()))
    count = torch.bincount(idx[valid], minlength=n).to(torch.float64)
    scale = (1.0 / count.clamp_min(1.0)).to(dt)
    return idx, inv, valid, scale


class CutFemSmoother:
    """Damped Jacobi + optional interface-dof block correction
    (cutmg.py:61-111), or patch-block additive Schwarz (``blocks``).

    The interface block is extracted once as its own ELL matrix
    (#if-dofs rows) and the correction is an inner Jacobi-CG on it, the
    reference's ``ifsolver='cg'`` branch.  Every product of the smoother
    (the residuals and the interface block's) goes through an ELL view
    whose layout is built here, so through kernel B2 on the card.  A block
    step is one gather, one batched product of the (nb, K, K) inverses and
    one scatter-add through a ``ScatterPlan``: a fixed order, so two runs
    give the same bits.
    """

    def __init__(self, A: SparseMatrix, freedofs=None, if_dofs=None,
                 damping=0.6, if_correction=True, if_maxit=40, if_tol=1e-4,
                 blocks=None, block_damping=0.7):
        self.A = A
        self.E = _ell_view(A)
        self.damping = damping
        dev = self.E.vals.device
        diag = self.E.diagonal()
        free = (np.ones(A.shape[0], bool) if freedofs is None
                else _bits(freedofs))
        free_t = torch.as_tensor(free, device=dev)
        self.dinv = torch.where((diag.abs() > 1e-30) & free_t,
                                1.0 / torch.where(diag == 0, 1.0, diag), 0.0)
        self.free = free_t
        self.ifsolve = None
        self.if_maxit = if_maxit
        self.if_tol = if_tol
        # patch-block smoothing (the reference's CreateBlockSmoother path
        # used by P2TwoGridCL, cutmg.py:264-297)
        self.blockdata = None
        self.block_damping = block_damping
        self.block_stats = {}
        if blocks is not None:
            self.blockdata = _prepare_blocks(A, blocks, free,
                                             self.block_stats)
            if self.blockdata is not None:
                idx, valid = self.blockdata[0], self.blockdata[2]
                self._plan = ScatterPlan(idx[valid], A.shape[0])
        if if_correction and if_dofs is not None:
            mask = _bits(if_dofs) & free
            if mask.any():
                cols = self.E.cols.cpu().numpy()
                st = _if_block_struct(cols, mask, cols.shape[1])
                self.ifsolve = _if_block_ell(
                    self.E.vals, *(torch.as_tensor(a, device=dev) for a in st),
                    fill=0.0)

    def smooth(self, x, b, steps=2):
        x, b = as_input(x, self.E), as_input(b, self.E)
        for _ in range(steps):
            r = b - self.E.matvec(x)
            if self.blockdata is not None:
                idx, inv, valid, scale = self.blockdata
                rb = torch.where(valid, r[idx], 0.0)  # (nb, K)
                zb = torch.bmm(inv, rb[:, :, None])[:, :, 0]
                dx = self._plan.add(zb[valid])
                x = x + self.block_damping * scale * dx
            else:
                x = x + self.damping * self.dinv * r
        if self.ifsolve is not None:
            idx, B, dsub = self.ifsolve
            r = b - self.E.matvec(x)
            z, _, _ = cg(B.matvec, r[idx], M=lambda s: dsub * s,
                         maxiter=self.if_maxit, tol=self.if_tol)
            x = x.index_add(0, idx, z)
        return x


class MultiGridCL:
    """V-cycle preconditioner over a space hierarchy (cutmg.py:17-57).

    ``mats`` [coarse..fine] and ``prols`` (level l -> l+1) are
    ``SparseMatrix`` objects (or prolongation objects); every level
    operator, restriction ``P.T`` and prolongation ``P`` applies through
    its ELL view, built here once (kernel B2 on the card).  The coarse free
    block is factored on the host in f64 (Cholesky, else LU) and the
    factors are carried to the matrices' device."""

    def __init__(self, mats, prols, smoothers, coarse_freedofs=None,
                 nsmooth=2):
        self.mats = mats  # [coarse..fine]
        self.prols = prols  # prols[l]: level l -> level l+1
        self.smoothers = smoothers  # per level (None on the coarsest)
        self.nsmooth = nsmooth
        self.ops = [_ell_view(A) for A in mats]
        self.P_ops = [_ell_view(P) for P in prols]
        self.R_ops = [_ell_view_T(P) for P in prols]
        dev, dt = mats[0].vals.device, mats[0].vals.dtype
        n0 = mats[0].shape[0]
        free = (np.ones(n0, bool) if coarse_freedofs is None
                else _bits(coarse_freedofs))
        idx = np.nonzero(free)[0]
        kind, F, *piv = _host_coarse_factor(
            mats[0].to_scipy().tocsr()[idx][:, idx].toarray())
        self._coarse_fac = (kind, torch.as_tensor(F, dtype=dt, device=dev),
                            *(torch.as_tensor(p + 1, dtype=torch.int32,
                                              device=dev) for p in piv))
        self._coarse_idx = torch.as_tensor(idx, device=dev)
        self._coarse_n = n0

    def _coarse_solve(self, b):
        bc = b[self._coarse_idx][:, None]
        if self._coarse_fac[0] == "chol":
            z = torch.cholesky_solve(bc, self._coarse_fac[1])
        else:
            z = torch.linalg.lu_solve(self._coarse_fac[1],
                                      self._coarse_fac[2], bc)
        out = torch.zeros(self._coarse_n, dtype=b.dtype, device=b.device)
        return out.index_copy(0, self._coarse_idx, z[:, 0])

    def _cycle(self, l, b):
        if l == 0:
            return self._coarse_solve(b)
        A, S = self.ops[l], self.smoothers[l]
        x = S.smooth(torch.zeros_like(b), b, self.nsmooth)
        r = b - A.matvec(x)
        rc = self.R_ops[l - 1].matvec(r)
        xc = self._cycle(l - 1, rc)
        x = x + self.P_ops[l - 1].matvec(xc)
        x = S.smooth(x, b, self.nsmooth)
        return x

    def __call__(self, b):
        return self._cycle(len(self.mats) - 1, as_input(b, self.ops[-1]))

    def matvec(self, b):
        return self(b)


class P1Prolongation:
    """Reference-style prolongation object (utils/xprolongation.hpp:13-40):
    constructed on a mesh, ``Update(fes)`` is called once per refinement
    level and records the transfer from the previous level's space; the
    transfer itself is the coarse-basis-at-fine-nodes matrix
    (``prolongation_matrix``, any order) on ``device`` (default: the
    space's device, the card unless the caller asks for the CPU).
    Transfers apply through the matrices' ELL views."""

    def __init__(self, mesh=None, device=None):
        self.mesh = mesh
        self.device = device
        self.spaces = []
        self.mats = []  # mats[l-1]: level l-1 -> level l

    def Update(self, fes):
        if self.spaces:
            dev = (self.device if self.device is not None
                   else getattr(fes, "_device", None))
            self.mats.append(prolongation_matrix(self.spaces[-1], fes,
                                                 device=dev))
        self.spaces.append(fes)

    def Prolongate(self, level, vec):
        """Transfer a level-(level-1) vector up to ``level`` (1-based); a
        numpy ``vec`` becomes a tensor on the transfer's device first."""
        P = _ell_view(self.mats[level - 1])
        return P.matvec(vec)

    def Restrict(self, level, vec):
        """Transpose-transfer a level vector down to level-1."""
        R = _ell_view_T(self.mats[level - 1])
        return R.matvec(vec)

    # finest-level matrix protocol so instances slot into MultiGridCL
    def matvec(self, x):
        return _ell_view(self.mats[-1]).matvec(x)

    @property
    def T(self):
        return _ell_view_T(self.mats[-1])


class P2Prolongation(P1Prolongation):
    """Order-2 variant (utils/xprolongation.hpp:42-71): the same
    construction, kept as a named class for API parity."""


class P2CutProlongation(P2Prolongation):
    """Cut-space variant (utils/xprolongation.hpp:73-101).  The XFE
    sign-mask split is applied outside the transfer here (the unfitted
    space stores per-element-dof sign masks), so the nodal transfer is
    that of P2Prolongation."""


class CompoundProlongation:
    """Block-diagonal prolongation for compound spaces (reference
    utils/python_utils.cpp:277-293): per-component prolongations.

    Accepts either a list of per-component prolongation matrices (matrix
    protocol) or, reference-style, the compound space followed by
    ``AddProlongation`` calls and per-level ``Update``."""

    def __init__(self, arg=None):
        if isinstance(arg, (list, tuple)):
            self.ps = list(arg)
            self.space = None
        else:
            self.ps = []
            self.space = arg

    def AddProlongation(self, p):
        self.ps.append(p)

    def Update(self, fes):
        for p, comp in zip(self.ps, fes.components):
            p.Update(comp)

    def _comp_mats(self):
        return [p.mats[-1] if isinstance(p, P1Prolongation) else p
                for p in self.ps]

    def matvec(self, x):
        outs, off = [], 0
        for P in self._comp_mats():
            nc = P.shape[1]
            outs.append(_ell_view(P).matvec(x[off:off + nc]))
            off += nc
        return torch.cat(outs)

    def Prolongate(self, level, vec):
        vec = as_input(vec, _ell_view(self.ps[0].mats[level - 1]))
        outs, off = [], 0
        for p in self.ps:
            nc = p.mats[level - 1].shape[1]
            outs.append(p.Prolongate(level, vec[off:off + nc]))
            off += nc
        return torch.cat(outs)

    def Restrict(self, level, vec):
        vec = as_input(vec, _ell_view(self.ps[0].mats[level - 1]))
        outs, off = [], 0
        for p in self.ps:
            nr = p.mats[level - 1].shape[0]
            outs.append(p.Restrict(level, vec[off:off + nr]))
            off += nr
        return torch.cat(outs)

    @property
    def T(self):
        mats = self._comp_mats()

        class _CPT:
            def matvec(_self, x):
                outs, off = [], 0
                for P in mats:
                    nr = P.shape[0]
                    outs.append(_ell_view_T(P).matvec(x[off:off + nr]))
                    off += nr
                return torch.cat(outs)

        return _CPT()


class P2TwoGridCL:
    """Two-grid solver for order-2 cut problems (cutmg.py:264-331): a
    patch-block CutFemSmoother on the P2 system + a P1 coarse correction
    driven by a LinearMGIterator (or any preconditioner/solver callable, or
    an object that solves by ``*`` such as ``Inverse()``), iterated to
    tolerance.

    kwargs (reference names): a (SparseMatrix or object with .mat), fes,
    mesh, ci, ifsolver, linmgiter, coarse_space (the P1 space the
    linmgiter lives on; default H1(mesh, order=1) on the matrix's device),
    patchtype ('edge'|'vert'|'elem'), nu, maxit, tol, printinfo.  Every
    product runs through an ELL view (kernel B2 on the card)."""

    def __init__(self, **kwargs):
        a = kwargs["a"]
        self.A = a.mat if hasattr(a, "mat") else a
        self.fes = kwargs["fes"]
        mesh = kwargs.get("mesh", self.fes.mesh)
        patchtype = kwargs.get("patchtype", "edge")
        if patchtype == "edge":
            blocks = EdgePatches(self.fes, mesh)
        elif patchtype == "vert":
            blocks = VertPatches(self.fes, mesh)
        elif patchtype == "elem":
            blocks = ElemPatches(self.fes)
        else:
            raise ValueError(
                "Unknown patchtype for block smoothing! "
                "choose between 'edge', 'vert' and 'elem'")
        ci = kwargs.get("ci")
        if_dofs = None
        if ci is not None:
            from ..domaintype import IF
            from ..fem.space import GetDofsOfElements

            if_dofs = GetDofsOfElements(self.fes, ci.GetElementsOfType(IF))
        self.smoother = CutFemSmoother(
            self.A, freedofs=self.fes.FreeDofs(), if_dofs=if_dofs,
            blocks=blocks,
            if_correction=kwargs.get("ifsolver") is not None)
        self.E = self.smoother.E
        self.linmgiter = kwargs["linmgiter"]
        dev = self.E.vals.device
        coarse_space = kwargs.get("coarse_space")
        if coarse_space is None:
            from ..fem.space import H1

            coarse_space = H1(mesh, order=1, device=dev)
        self.P = prolongation_matrix(coarse_space, self.fes,
                                     dtype=self.E.vals.dtype, device=dev)
        self.P_op, self.R_op = _ell_view(self.P), _ell_view_T(self.P)
        self.nu = kwargs.get("nu", 3)
        self.maxit = kwargs.get("maxit", 20)
        self.tol = kwargs.get("tol", 1e-6)
        self.printinfo = kwargs.get("printinfo", False)
        self.free = torch.as_tensor(_bits(self.fes.FreeDofs()), device=dev)
        self.iterations = 0

    def _coarse_correct(self, r):
        rc = self.R_op.matvec(r)
        if callable(self.linmgiter):
            zc = self.linmgiter(rc)
        else:
            zc = self.linmgiter * rc
        return self.P_op.matvec(zc)

    def Mult(self, rhs, usol=None):
        """Iterate to tolerance; returns the solution.  ``usol`` follows the
        reference's out-parameter convention (cutmg.py P2TwoGridCL.Mult): a
        tensor, numpy array or vector shim passed as ``usol`` receives the
        solution in place (its incoming values also serve as the initial
        iterate)."""
        E = self.E.vals
        free = as_input(self.free, E, dtype=torch.bool)
        b = torch.where(free, as_input(rhs, E).to(E.device, E.dtype), 0.0)
        if usol is not None:
            x0 = as_input(usol, E).to(E.device, E.dtype)
            x = torch.where(free, x0, 0.0)
        else:
            x = torch.zeros_like(b)
        normb = float(torch.linalg.vector_norm(b))
        for it in range(self.maxit):
            x = self.smoother.smooth(x, b, self.nu)
            r = torch.where(free, b - self.E.matvec(x), 0.0)
            # mask the prolongated correction: unmasked it deposits values
            # at non-free (Dirichlet/inactive) dofs that no free-masked
            # smoother or residual ever cleans up
            x = x + torch.where(free, self._coarse_correct(r), 0.0)
            x = self.smoother.smooth(x, b, self.nu)
            r = torch.where(free, b - self.E.matvec(x), 0.0)
            res = float(torch.linalg.vector_norm(r)) / max(normb, 1e-300)
            self.iterations = it + 1
            if self.printinfo:
                print("it =", it + 1, " ||res||_2 =", res)
            if res < self.tol:
                break
        if usol is not None:
            if torch.is_tensor(usol):
                usol.copy_(x)
            elif isinstance(usol, np.ndarray):
                usol[:] = x.cpu().numpy()
            else:
                try:
                    usol.data = x  # vector shims expose .data
                except AttributeError:
                    import warnings

                    warnings.warn(
                        "P2TwoGridCL.Mult: usol out-parameter is not "
                        "writable; use the return value")
        return x

    def __mul__(self, rhs):
        return self.Mult(rhs)

    def Height(self):
        return self.A.shape[0]

    def Width(self):
        return self.A.shape[0]


def coo_to_ell_np(rows, cols, vals, shape):
    """Host: COO triplets -> padded ELL (cols (n,K) int32, vals (n,K) f64)."""
    import scipy.sparse as sp

    A = sp.coo_matrix((np.asarray(vals, dtype=np.float64),
                       (np.asarray(rows), np.asarray(cols))),
                      shape=shape).tocsr()
    A.sum_duplicates()
    n = shape[0]
    counts = np.diff(A.indptr)
    K = max(int(counts.max()), 1)
    ecols = np.zeros((n, K), dtype=np.int32)
    evals = np.zeros((n, K), dtype=np.float64)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    rix = np.repeat(np.arange(n), counts)
    ecols[rix, pos] = A.indices
    evals[rix, pos] = A.data
    return ecols, evals


def prolongation_coo_np(coarse_space, fine_space):
    """Host COO (rows, cols, vals, shape) of the coarse->fine prolongation
    (host numpy only; vals in f64, the JAX package's default dtype)."""
    return _prolongation_coo(coarse_space, fine_space)


def _if_block_struct(cols_np, if_mask, K):
    """Host: padded interface sub-block structure of an ELL matrix.

    Returns (idx (m,), bcols (m,Kc) local col ids, bslots (m,Kc) flat slots
    into the (n*K,) value table, bmask (m,Kc)): value slots, so the block
    tracks a re-assembled matrix with no host work."""
    idx = np.nonzero(if_mask)[0]
    m = len(idx)
    if m == 0:
        return (np.zeros(0, np.int32), np.zeros((0, 1), np.int32),
                np.zeros((0, 1), np.int64), np.zeros((0, 1), bool))
    g2l = np.full(cols_np.shape[0], -1, dtype=np.int64)
    g2l[idx] = np.arange(m)
    sub = cols_np[idx]  # (m, K)
    loc = g2l[sub]
    inb = loc >= 0
    Kc = max(int(inb.sum(1).max()), 1)
    order = np.argsort(~inb, axis=1, kind="stable")[:, :Kc]
    ri = np.arange(m)[:, None]
    bcols = np.where(inb[ri, order], loc[ri, order], 0).astype(np.int32)
    bslots = (idx[:, None] * np.int64(K) + order).astype(np.int64)
    bmask = inb[ri, order]
    return idx.astype(np.int32), bcols, bslots, bmask


def _if_block_ell(vals, idx, bcols, bslots, bmask, fill):
    """The interface block of the ELL value table ``vals`` as its own
    ``ELLMatrix`` (layout built), from ``_if_block_struct``'s tables as
    tensors on ``vals``' device: (dof ids, block, inverse diagonal), the
    inverse ``fill`` where the diagonal vanishes (the reference's
    ``CutFemSmoother`` puts 0 there, its ``FunctionalELLMG`` 1)."""
    bvals = torch.where(bmask != 0, vals.reshape(-1)[bslots], 0.0)
    B = ELLMatrix(bcols, bvals.contiguous(), (idx.shape[0], idx.shape[0]))
    B.layout()
    d = B.diagonal()
    return (idx.long(), B,
            torch.where(d.abs() > 1e-30, 1.0 / torch.where(d == 0, 1.0, d),
                        fill))


def _host_coarse_factor(A0):
    """Factor the dense coarse block ``A0`` (host f64) after symmetrizing
    it: ("chol", L), L lower, for an SPD block, else ("lu", lu, piv), as
    ``scipy.linalg.lu_factor`` gives them (a device Cholesky would give
    NaNs silently on an indefinite Nitsche coarse block)."""
    A0 = 0.5 * (A0 + A0.T)
    try:
        return ("chol", np.linalg.cholesky(A0))
    except np.linalg.LinAlgError:
        import scipy.linalg as sla

        return ("lu", *sla.lu_factor(A0))


class FunctionalELLMG:
    """Cut-MG V-cycle over a hierarchy of ELL operators, in functional form.

    The host constructor takes per-level static structure; ``params``
    packs the current per-level ELL value tables with the static index
    tables into one dictionary of device tensors; ``prepare`` (device
    Cholesky) or ``prepare_host`` (host f64 inverse) handles the coarse
    level once per assembled matrix; ``apply(params, b)`` is the V-cycle
    preconditioner.  Smoothing is damped Jacobi plus an optional
    fixed-iteration CG on the interface dof block, all with fixed trip
    counts.
    """

    def __init__(self, cols_list, prols_coo, if_masks=None, nsmooth=2,
                 damping=0.6, if_iters=10, active_masks=None):
        self.nlevels = len(cols_list)
        self.nsmooth = nsmooth
        self.damping = damping
        self.if_iters = if_iters
        self.cols_np = [np.asarray(c) for c in cols_list]
        self.K = [c.shape[1] for c in self.cols_np]
        self.P_ell = []   # coarse->fine, ELL by fine row
        self.R_ell = []   # fine->coarse (P^T), ELL by coarse row
        for (rows, cols, vals, shape) in prols_coo:
            self.P_ell.append(coo_to_ell_np(rows, cols, vals, shape))
            self.R_ell.append(coo_to_ell_np(cols, rows, vals,
                                            (shape[1], shape[0])))
        self.active_np = (None if active_masks is None else
                          [None if a is None else np.asarray(a, dtype=bool)
                           for a in active_masks])
        self.if_structs = []
        for l in range(self.nlevels):
            if if_masks is not None and if_masks[l] is not None and l > 0:
                self.if_structs.append(
                    _if_block_struct(self.cols_np[l],
                                     np.asarray(if_masks[l], dtype=bool),
                                     self.K[l]))
            else:
                self.if_structs.append(None)

    def params(self, vals_list, dtype=None, *, device=None):
        """Pack the static tables and the current ELL values (numpy arrays,
        e.g. the JAX package's, or tensors) into a dictionary of tensors of
        ``dtype`` (default ``config.dtype``) on ``device`` (the card unless
        the caller asks for the CPU)."""
        dtype = torch_dtype(dtype) or config.dtype
        dev = resolve_device(device)

        def t(a, dt=None):
            # np.array copies: a read-only host array (a JAX array's view)
            # cannot back a tensor
            return torch.as_tensor(a if torch.is_tensor(a) else np.array(a),
                                   dtype=dt, device=dev).contiguous()

        return {
            "cols": [t(c, torch.int32) for c in self.cols_np],
            "vals": [t(v, dtype) for v in vals_list],
            "P": [(t(c, torch.int32), t(v, dtype)) for c, v in self.P_ell],
            "R": [(t(c, torch.int32), t(v, dtype)) for c, v in self.R_ell],
            "if": [None if s is None else
                   (t(s[0], torch.int64), t(s[1], torch.int32),
                    t(s[2], torch.int64), t(s[3], dtype))
                   for s in self.if_structs],
            "act": (None if self.active_np is None else
                    [None if a is None else t(a, torch.bool)
                     for a in self.active_np]),
        }

    @staticmethod
    def _mv(params, l, x):
        return params["ops"][l].matvec(x)

    def _operators(self, params):
        """The cycle's tables as ``ELLMatrix`` objects, their layouts built
        here on the card (``ELLMatrix.layout``; none on the CPU): the level
        operators ``ops`` with their Jacobi inverse diagonals ``dinv``, the
        transfers ``R_ops`` and ``P_ops``, and per level the interface block
        ``if_ops`` (None or (dof ids, block, inverse diagonal)), its values
        gathered from the level's table here, once."""
        cols, vals = params["cols"], params["vals"]

        def ell(c, v, ncols):
            A = ELLMatrix(c, v, (c.shape[0], ncols))
            A.layout()
            return A

        out = {
            "ops": [ell(c, v, c.shape[0]) for c, v in zip(cols, vals)],
            "R_ops": [ell(c, v, cols[l + 1].shape[0])
                      for l, (c, v) in enumerate(params["R"])],
            "P_ops": [ell(c, v, cols[l].shape[0])
                      for l, (c, v) in enumerate(params["P"])],
        }
        out["dinv"] = [torch.where(d.abs() > 1e-30, 1.0 / d, 1.0)
                       for d in (A.diagonal() for A in out["ops"])]
        out["if_ops"] = [None if s is None or self.if_iters <= 0 else
                         _if_block_ell(vals[l], *s, fill=1.0)
                         for l, s in enumerate(params["if"])]
        return out

    def prepare(self, params):
        """Factor the coarse level on the device (dense Cholesky of the full
        coarse ELL, identity rows included; requires an SPD coarse system).
        Returns params + the factor.  In f32 the Cholesky of the
        ill-conditioned coarse Nitsche block loses too much precision: use
        ``prepare_host`` for f32 solves."""
        cols0, vals0 = params["cols"][0], params["vals"][0]
        n0 = cols0.shape[0]
        rows = torch.arange(n0, device=cols0.device)[:, None].expand(cols0.shape)
        A0 = torch.zeros((n0, n0), dtype=vals0.dtype, device=vals0.device)
        A0.index_put_((rows.reshape(-1), cols0.reshape(-1).long()),
                      vals0.reshape(-1), accumulate=True)
        A0 = 0.5 * (A0 + A0.T)
        out = dict(params)
        out["chol0"] = torch.linalg.cholesky(A0)
        out["ainv0"] = None
        out.update(self._operators(params))
        return out

    def prepare_host(self, params):
        """Host variant of ``prepare``: the coarse system is inverted in
        numpy f64 (its condition ~ lam/h * h^-2 overwhelms an f32
        factorization) and stored at the device dtype; the per-cycle coarse
        solve is one dense matvec.  One device-to-host copy of the coarse
        level per assembled matrix."""
        import scipy.linalg as sla

        cols0 = params["cols"][0].cpu().numpy()
        vals0 = params["vals"][0].cpu().numpy().astype(np.float64)
        n0 = cols0.shape[0]
        A0 = np.zeros((n0, n0))
        np.add.at(A0, (np.repeat(np.arange(n0), cols0.shape[1]),
                       cols0.reshape(-1)), vals0.reshape(-1))
        kind, F, *piv = _host_coarse_factor(A0)
        Ainv = (sla.cho_solve((F, True), np.eye(n0)) if kind == "chol" else
                sla.lu_solve((F, piv[0]), np.eye(n0)))
        v0 = params["vals"][0]
        out = dict(params)
        out["ainv0"] = torch.as_tensor(Ainv, dtype=v0.dtype, device=v0.device)
        out["chol0"] = None
        out.update(self._operators(params))
        return out

    def _if_correct(self, params, l, x, b):
        s = params["if_ops"][l]
        if s is None:
            return x
        idx, B, dinv = s
        r = (b - self._mv(params, l, x))[idx]
        z, _, _ = cg(B.matvec, r, M=lambda v: dinv * v, maxiter=self.if_iters,
                     tol=0.0)
        return x.index_add(0, idx, z)

    def _smooth(self, params, l, x, b):
        for _ in range(self.nsmooth):
            r = b - self._mv(params, l, x)
            x = x + self.damping * params["dinv"][l] * r
        return x

    def _cycle(self, params, l, b):
        if l == 0:
            if params.get("ainv0") is not None:
                return torch.matmul(params["ainv0"], b)
            return torch.cholesky_solve(b[:, None], params["chol0"])[:, 0]
        x = self._smooth(params, l, torch.zeros_like(b), b)
        x = self._if_correct(params, l, x, b)
        r = b - self._mv(params, l, x)
        rc = params["R_ops"][l - 1].matvec(r)
        act = params.get("act")
        if act is not None and act[l - 1] is not None:
            # active-set-aware transfer (utils/xprolongation.hpp:60-101):
            # inactive coarse dofs carry identity rows, so no residual is
            # restricted into them
            rc = torch.where(act[l - 1], rc, 0.0)
        xc = self._cycle(params, l - 1, rc)
        corr = params["P_ops"][l - 1].matvec(xc)
        if act is not None and act[l] is not None:
            corr = torch.where(act[l], corr, 0.0)
        x = x + corr
        x = self._if_correct(params, l, x, b)
        x = self._smooth(params, l, x, b)
        return x

    def apply(self, params, b):
        """One V-cycle: z approx A^{-1} b (use as CG preconditioner)."""
        return self._cycle(params, self.nlevels - 1, b)


class LinearMGIterator:
    """Stationary MG iteration / solver (cutmg.py:115+): MG-
    preconditioned CG on the free-dof-masked system, its products through
    the matrix's ELL view."""

    def __init__(self, mgpre: MultiGridCL, mat, freedofs=None, maxit=50,
                 tol=1e-8):
        self.mg = mgpre
        self.mat = mat
        self.freedofs = freedofs
        self.maxit = maxit
        self.tol = tol

    def __mul__(self, rhs):
        A = _ell_view(self.mat)
        b = as_input(rhs, A)
        mv = A.matvec
        M = self.mg
        if self.freedofs is not None:
            fm = torch.as_tensor(_bits(self.freedofs), device=b.device)
            mv = masked_matvec(mv, fm)
            b = torch.where(fm, b, 0.0)
            M = lambda r: torch.where(fm, self.mg(r), r)
        x, k, res = cg(mv, b, M=M, maxiter=self.maxit, tol=self.tol)
        return x
