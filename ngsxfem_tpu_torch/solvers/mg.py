"""Cut geometric multigrid over ELL operators: the functional V-cycle.

Counterpart of ``ngsxfem_tpu/solvers/mg.py:21-112,583-819``: the nodal
prolongation (coarse basis evaluated at fine dof nodes), its host COO/ELL
forms, the interface-block structure and ``FunctionalELLMG``, the cut-MG
V-cycle with damped-Jacobi smoothing plus a fixed-iteration CG on the
interface dof block (the CutFemSmoother design of the reference's
``python/cutmg.py:17-111``).  Host setup is numpy; ``params`` carries the
tables to the device.  Every ELL product of the V-cycle (level operator,
restriction, prolongation, interface block) goes through
``ell_spmv.ell_matvec``, the hand-written ELL kernel on the card.  The
coarse solve is a dense ``torch.matmul`` with the host-computed inverse
(``prepare_host``) or a Cholesky solve (``prepare``); float32 products run
in full float32 (``config.py`` turns TF32 off).  ``prepare`` and
``prepare_host`` wrap every table of the cycle in an ``ELLMatrix`` and, on
the card, build its sliced layout there, once per assembled matrix, so that
no product of a cycle builds one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import config, resolve_device
from .krylov import cg
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
    pts[fine_space.el2dof_np.reshape(-1)] = fnodes.reshape(-1, fm.dim)

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
    dtype = dtype or config.dtype
    return SparseMatrix(rows, cols, torch.as_tensor(vals, dtype=dtype), shape,
                        device=device)


def _invert_geom_pp(et, verts, pts):
    """Local coords of physical pts, per-point element vertices.

    verts (N, nvel, d), pts (N, d) -> (N, d); affine exact for simplices.
    """
    d = pts.shape[1]
    if et not in ("trig", "tet", "segm"):
        # the reference runs a batched Newton here, which needs the
        # geometry shape gradients (mesh.geom_dshapes) the port lacks
        raise NotImplementedError("prolongation on quad/hex meshes")
    v0 = verts[:, 0]
    E = np.swapaxes(verts[:, 1:d + 1] - v0[:, None], 1, 2)  # (N, d, d)
    return np.linalg.solve(E, (pts - v0)[..., None])[..., 0]


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
        dtype = dtype or config.dtype
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

    @staticmethod
    def _inv_diag(A):
        d = A.diagonal()
        return torch.where(d.abs() > 1e-30, 1.0 / d, 1.0)

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
            "if_ops": [],
        }
        out["dinv"] = [self._inv_diag(A) for A in out["ops"]]
        for l, s in enumerate(params["if"]):
            if s is None or self.if_iters <= 0:
                out["if_ops"].append(None)
                continue
            idx, bcols, bslots, bmask = s
            B = ell(bcols, (vals[l].reshape(-1)[bslots] * bmask).contiguous(),
                    idx.shape[0])
            out["if_ops"].append((idx, B, self._inv_diag(B)))
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
        A0 = 0.5 * (A0 + A0.T)
        try:
            cf = sla.cho_factor(A0)
            Ainv = sla.cho_solve(cf, np.eye(n0))
        except np.linalg.LinAlgError:
            Ainv = sla.lu_solve(sla.lu_factor(A0), np.eye(n0))
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
