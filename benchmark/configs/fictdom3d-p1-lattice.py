"""Driver of the configuration ``fictdom3d-p1-lattice``.

The repository's flagship model, ``UnfittedPoisson(nx, dim=3, order=1,
dtype=float32)`` (the reference's ``py_tutorials/fictdom_ghostpen.py`` in
3D as the repository's ``bench.py`` runs it): the offset-diagonal (DIA)
structure once in set-up (it depends on the topology only), then per step
the active dofs (``active_dof_mask``), the lattice assembly of the DIA
table in float32 (``assemble_vals_lattice``) and the converged solve of
``bench.py``: iterative refinement (``krylov.cg_ir``: float32 Jacobi-PCG
inside, float64 residuals on the float64 copy of the table), and where its
true float64 residual is still above the configuration's tolerance (the
float32 inner solve stalls at some positions of the sphere), float64
Jacobi-PCG (``krylov.cg``) from the refinement's solution.

The benchmark makes the level set ``|x - c| - r`` (float32) on the device
from its own vertex coordinates and the step's centre, and the right-hand
side ``b = f(x)`` on the active dofs, 0 elsewhere (the active-dof
indicator for the configuration's load ``f = 1``).  The geometry moves
each step.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from harness import judge
from reference import cutp1

SOLVE_TOL = 1e-14       # reference CG, relative residual of its recurrence
SOLVE_MAXITER = 50000
FALLBACK_MAXITER = 20000  # the float64 fallback's iterations at most


def setup(sizes, traffic, device):
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson

    nx = sizes["nx"]
    model = UnfittedPoisson(nx=nx, dim=3, order=1, dtype=torch.float32,
                            lam_nitsche=sizes["nitsche"],
                            gamma_gp=sizes["ghost_penalty"],
                            radius=sizes["radius"], device=device)
    struct = model.dia_structure()
    offsets = struct["offsets"]
    st = SimpleNamespace(model=model, struct=struct, offsets=offsets,
                         k0=int(np.searchsorted(offsets, 0)),
                         perm_inv=torch.as_tensor(struct["perm_inv"],
                                                  device=device),
                         X=vertices(sizes, device), sizes=sizes, nnz={},
                         outer=sizes["ir_outer"], inner=sizes["ir_inner"],
                         tol=sizes["solve_tol"])
    return st


def vertices(sizes, device):
    """Vertex coordinates (float64) of the lattice, vertex (i, j, k) at
    ``(i * (nx + 1) + j) * (nx + 1) + k``."""
    axis = torch.as_tensor(np.linspace(*sizes["box"], sizes["nx"] + 1),
                           dtype=torch.float64, device=device)
    ii, jj, kk = torch.meshgrid(axis, axis, axis, indexing="ij")
    return torch.stack([ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)], 1)


def level_set(X, centre, sizes):
    """The float32 level set both sides are given."""
    c = torch.as_tensor(centre, dtype=torch.float64, device=X.device)
    return (torch.linalg.vector_norm(X - c, dim=1)
            - sizes["radius"]).to(torch.float32)


def load_values(X, load):
    a0, a = load
    return a0 + X @ torch.as_tensor(a, dtype=X.dtype, device=X.device)


def _assemble(st, lset, spans):
    with spans("lattice_assemble"):
        active = st.model.active_dof_mask(lset)
        V, ncut = st.model.assemble_vals_lattice(st.model.vertices, lset,
                                                 st.struct)
    return {"V": V, "ncut": ncut, "active": active[st.perm_inv]}


def step(st, inp, spans):
    from ngsxfem_tpu_torch.solvers.krylov import cg, cg_ir
    from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

    asm = _assemble(st, level_set(st.X, inp.centre, st.sizes), spans)
    V = asm["V"]
    b = torch.where(asm["active"], load_values(st.X, inp.load),
                    0.0).to(torch.float32)
    offs = st.offsets
    with spans("solve"):
        V64 = V.double()
        d = V[st.k0]
        dinv = torch.where(d.abs() > 1e-30, 1.0 / d, 1.0)

        def matvec64(v):
            return dia_matvec(offs, V64, v)

        x64, res = cg_ir(lambda v: dia_matvec(offs, V, v), matvec64, b,
                         M=lambda r: dinv * r, outer=st.outer,
                         inner=st.inner)
        fallback = 0
        b64 = b.double()
        if float(res) > st.tol * float(torch.linalg.vector_norm(b64)):
            d64 = V64[st.k0]
            dinv64 = torch.where(d64.abs() > 1e-30, 1.0 / d64, 1.0)
            # to a tenth of the tolerance: the recurrence's residual drifts
            # from the true one, which has to meet the tolerance
            x64, fallback, res = cg(matvec64, b64, x0=x64,
                                    M=lambda r: dinv64 * r,
                                    maxiter=FALLBACK_MAXITER,
                                    tol=0.1 * st.tol)
    return {**asm, "b": b, "sol": x64, "res": res, "fallback": fallback}


def work(st, out):
    """The solve's products and iterations as the algorithm needs them:
    per outer step of the refinement ``inner`` float32 products and one
    float64 residual product, ``inner`` float32 CG iterations and one
    float64 update; for a float64 fallback of ``k`` iterations ``k + 1``
    float64 products and ``k`` float64 iterations.  A product reads the
    nonzero slots of the active rows (no column: a diagonal's offset gives
    it); vectors are as long as the active dofs (the inactive rows are the
    identity and their unknowns 0: a layout's length, not the problem's)."""
    V = out["V"]
    key = id(V)
    if key not in st.nnz:
        act = out["active"]
        st.nnz = {key: (int(torch.count_nonzero(V[:, act])),
                        int(act.sum()))}
    nnz, n = st.nnz[key]
    o, i = st.outer, st.inner
    k = int(out["fallback"])
    return {"solve": {"products": [(o * i, nnz, n, 4, 0), (o, nnz, n, 8, 0),
                                   (k + 1 if k else 0, nnz, n, 8, 0)],
                      "iterations": [(o * i, n, 4), (o, n, 8), (k, n, 8)]}}


def release(st):
    return {"offsets": st.offsets}


def reference(lat, sizes, inp):
    """Reference system (the lattice model's identity rows on the inactive
    dofs), right-hand side and solution of one step's inputs, in the dtype
    of the lattice's coordinates."""
    dt = lat.X.dtype
    phi = level_set(lat.X.double(), inp.centre, sizes).to(dt)
    S = cutp1.assemble(lat, phi, sizes["nitsche"], sizes["ghost_penalty"],
                       inp.load, identity_inactive=True)
    b = torch.where(S.active, load_values(lat.X, inp.load).to(dt), 0.0)
    return S, b


def _solve(A, b, tol):
    free = torch.ones_like(b, dtype=torch.bool)
    x, _, _ = cutp1.pcg(A, b, free, tol, SOLVE_MAXITER)
    return x


def residual(matvec, x, b):
    """``||b - A x|| / ||b||`` in float64, ``b`` the load as the program is
    given it (float32): how far the float64 refinement brought the
    solution of its own table."""
    b = b.to(torch.float32).to(torch.float64)
    return float(torch.linalg.vector_norm(b - matvec(x.to(torch.float64)))
                 / torch.linalg.vector_norm(b).clamp_min(1e-300))


def compare(sizes, traffic, samples, meta, device, seed):
    """Numbers of each sampled step against the float64 reference, and
    ``res``, the float64 residual of the program's solution on its own
    table."""
    lat = cutp1.Lattice(sizes["nx"], *sizes["box"], device)
    probe = _probe(lat, seed)
    out = []
    for inp, o in samples:
        S, b = reference(lat, sizes, inp)
        x = _solve(S.csr(), b, SOLVE_TOL)
        V = o["V"]

        def matvec(v, V=V):
            return judge.dia_product(meta["offsets"], V, v)

        canon = {"ncut": int(o["ncut"]), "active": o["active"],
                 "matvec": matvec, "sol": o["sol"]}
        r = judge.numbers(canon, S, x, probe)
        r["res"] = residual(matvec, o["sol"], b)
        out.append(r)
    return out


def control(sizes, traffic, inputs, device, seed):
    """The comparison's numbers of the reference in the program's place one
    precision below: the table assembled in float32 and held in bfloat16,
    the solve in float32 with no float64 refinement."""
    lat = cutp1.Lattice(sizes["nx"], *sizes["box"], device)
    lat32 = lat.with_dtype(torch.float32)
    probe = _probe(lat, seed)
    out = []
    for inp in inputs:
        S, b = reference(lat, sizes, inp)
        x = _solve(S.csr(), b, SOLVE_TOL)
        S32, b32 = reference(lat32, sizes, inp)
        A32 = S32.csr()  # the summed table, each entry rounded to bfloat16
        A16 = torch.sparse_csr_tensor(
            A32.crow_indices(), A32.col_indices(),
            A32.values().to(torch.bfloat16).float(), A32.shape)
        x32 = _solve(A16, b32, 1e-6)

        def matvec(v, A=A16):
            return (A @ v.float()[:, None])[:, 0].double()

        canon = {"ncut": int(S32.cut.sum()), "active": S32.active,
                 "matvec": matvec, "sol": x32.double()}
        r = judge.numbers(canon, S, x, probe)
        r["res"] = residual(matvec, x32, b)
        out.append(r)
    return out


def _probe(lat, seed):
    g = torch.Generator(device=lat.X.device).manual_seed(int(seed) % 2 ** 62)
    return torch.rand(lat.nv, dtype=torch.float64, device=lat.X.device,
                      generator=g) * 2 - 1
