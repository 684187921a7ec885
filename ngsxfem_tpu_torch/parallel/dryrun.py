"""The parallel layouts of the flagship, run on the ranks of a process group
and held against the single-rank solve.

Counterpart of ``__graft_entry__._dryrun_multichip_impl``.  Four layouts of
``UnfittedPoisson``:

- A, element-sharded (``spmd_step``): one ``all_reduce`` of the whole dof
  vector per product;
- B, dof-sharded (``spmd_step_sharded``): one ``all_reduce`` of the shared
  (halo-layer) buffer per product;
- C, lattice slabs (``LatticeShard``): the two halo windows of each slab
  exchanged with the neighbouring ranks per product;
- D, the end-to-end sharded flagship: each rank assembles the DIA rows of
  its slab (``assemble_vals_lattice(planes=...)``) from its vertex and
  level-set planes plus the halo planes ``LatticeShard.halo`` brings, then
  ``cg_ir`` runs on the slab product with all-reduced dots.

``dryrun_multichip(n)`` starts one NCCL rank per card on n cards
(``spawn_ranks``), or n gloo ranks on the CPU with ``device="cpu"``, and
runs all four, the halo/payload table at nx=24 over 2, 4 and 8 ranks
included.  ``chip_smoke.py`` phase 28 runs it on every card of its host and
the layouts at nx=48 at world size 1 through NCCL.
"""
from __future__ import annotations

import numpy as np
import torch

from .latticeshard import LatticeShard
from .sharding import spawn_ranks

# planes of vertex and level-set data a slab's DIA rows need beyond it: a
# ghost-penalty patch spans two cells on each side of a vertex plane
ASM_HALO_PLANES = 2
# the reference's dry run (__graft_entry__._dryrun_multichip_impl): the
# layouts at nx=12 with a 25-iteration CG, the halo table at nx=24 with 10,
# layout D at nx=15 (nv1=16 divides every width), widths 2, 4, 8; float64
LAYOUT_NX, LAYOUT_ITERS = 12, 25
SCALE_NX, SCALE_ITERS = 24, 10
D_NX = 15
WIDTHS = (2, 4, 8)


def _rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float(torch.linalg.vector_norm(a.cpu() - b.cpu())
                 / torch.linalg.vector_norm(b.cpu()).clamp_min(1e-300))


def indicator(model, dst=None):
    """The indicator load of the active dofs: dof numbering, or the
    vertex-lexicographic one of the DIA structure ``dst``."""
    act = model.active_dofs if dst is None else \
        model.active_dofs[dst["perm_inv"]]
    return torch.as_tensor(np.where(act, 1.0, 0.0), dtype=model.dtype,
                           device=model.vertices.device)


def single_apply_cg(model, maxiter, tol=1e-8):
    """Layouts A and B's single-rank reference: CG on their operator on one
    device (``UnfittedPoisson.replicated_operator``) with the indicator
    load."""
    from ..solvers.krylov import cg

    x, _, res = cg(model.replicated_operator(), indicator(model),
                   maxiter=maxiter, tol=tol)
    return x, res


def jacobi(V, k0):
    """The Jacobi inverse diagonal of a DIA table (1 on empty rows)."""
    return torch.where(V[k0].abs() > 1e-30, 1.0 / V[k0], 1.0)


def layout_c(model, dst, V, group, maxiter, tol):
    """Jacobi-PCG on the lattice-slab operator of the DIA table ``V``.
    Returns (x (n,) gathered, residual norm, the ``LatticeShard``, bytes
    this rank's collectives moved in the solve)."""
    from ..solvers.krylov import cg

    ls = LatticeShard(dst["offsets"], model.nx + 1, model.dim, group)
    k0 = int(np.searchsorted(dst["offsets"], 0))
    Vl = ls.pad_table(V)
    dinv = ls.pad_x(jacobi(V, k0))
    b = ls.pad_x(indicator(model, dst))
    bytes0 = group.bytes
    x, _, res = cg(lambda z: ls.matvec(Vl, z), b, M=lambda r: dinv * r,
                   maxiter=maxiter, tol=tol, dot=ls.dot)
    return ls.gather_x(x), res, ls, group.bytes - bytes0


def single_dia_cg(model, dst, V, maxiter, tol):
    """Layout C's single-rank reference: the same PCG on ``dia_matvec``."""
    from ..solvers.krylov import cg
    from ..solvers.sparse import dia_matvec

    k0 = int(np.searchsorted(dst["offsets"], 0))
    dinv = jacobi(V, k0)
    x, _, res = cg(lambda z: dia_matvec(dst["offsets"], V, z),
                   indicator(model, dst), M=lambda r: dinv * r,
                   maxiter=maxiter, tol=tol)
    return x, res


def slab_rows(model, dst, ls):
    """This rank's rows (n_off, Lp) of the flagship's DIA table, assembled
    from its slab of vertices and level-set values and the
    ``ASM_HALO_PLANES`` planes on each side that ``ls.halo`` exchanges (a
    rank holds its planes only; here they are cut from the model's
    arrays).  Rows beyond the lattice (padding) are zero."""
    plane, nv1, h = ls.plane, ls.nv1, ASM_HALO_PLANES
    vl = ls.pad_x(model.vertices)
    ll = ls.pad_x(model.lset)
    vp, vn = ls.halo(vl, h * plane)
    lp, ln = ls.halo(ll, h * plane)
    z0 = ls.rank * ls.L
    z1 = min(z0 + ls.L, nv1)
    n_off = len(dst["offsets"])
    out = vl.new_zeros((n_off, ls.Lp))
    if z1 <= z0:  # a rank past the lattice's end holds padding only
        return out
    # the box of planes [p0, p1) inside the lattice, cut from
    # [halo before | slab | halo after], which starts at plane z0 - h
    p0, p1 = max(z0 - h, 0), min(z1 + h, nv1)
    cut = slice((p0 - z0 + h) * plane, (p1 - z0 + h) * plane)
    Vb, _ = model.assemble_vals_lattice(torch.cat([vp, vl, vn])[cut],
                                        torch.cat([lp, ll, ln])[cut], dst,
                                        planes=(p0, p1))
    out[:, :(z1 - z0) * plane] = Vb[:, (z0 - p0) * plane:(z1 - p0) * plane]
    return out


def pipeline_d(V, b, offsets, matvec32, matvec64, dot=None, outer=3,
               inner=60):
    """Layout D's solve: ``cg_ir`` (f32 inner Jacobi-PCG, f64 outer
    residual) on the table ``V`` (a slab or the whole table)."""
    from ..solvers.krylov import cg_ir

    k0 = int(np.searchsorted(offsets, 0))
    V32 = V.float()
    dinv = jacobi(V32, k0)
    return cg_ir(lambda z: matvec32(V32, z), lambda z: matvec64(V, z),
                 b.float(), M=lambda r: dinv * r, outer=outer, inner=inner,
                 dot=dot)


def layout_d(model, dst, group, outer=3, inner=60):
    """The end-to-end sharded flagship: slab assembly (``slab_rows``) and
    ``cg_ir`` (``outer`` x ``inner``) on the slab product.  Returns (x (n,)
    gathered, true residual norm, this rank's rows (float64), the
    ``LatticeShard``)."""
    ls = LatticeShard(dst["offsets"], model.nx + 1, model.dim, group)
    Vl = slab_rows(model, dst, ls).double()
    x, res = pipeline_d(Vl, ls.pad_x(indicator(model, dst)), dst["offsets"],
                        ls.matvec, ls.matvec, dot=ls.dot, outer=outer,
                        inner=inner)
    return ls.gather_x(x), res, Vl, ls


def single_pipeline_d(model, dst, outer=3, inner=60):
    """Layout D's single-rank reference: the whole table's ``cg_ir``.
    Returns (x, true residual norm, the whole table (float64))."""
    from ..solvers.sparse import dia_matvec

    V, _ = model.assemble_vals_lattice(model.vertices, model.lset, dst)
    V = V.double()
    mv = lambda A, z: dia_matvec(dst["offsets"], A, z)
    x, res = pipeline_d(V, indicator(model, dst), dst["offsets"], mv, mv,
                        outer=outer, inner=inner)
    return x, res, V


def _say(group, text):
    if group.rank == 0:
        print(text, flush=True)


def run_layouts(group):
    """Layouts A, B and C at ``LAYOUT_NX`` on the ranks of ``group``, each
    held against the single-rank solve at the reference's tolerance
    (partially converged f64 CG: 1e-5).  Returns rank 0's numbers."""
    from ..models.poisson import UnfittedPoisson

    n, maxiter = group.world_size, LAYOUT_ITERS
    m = UnfittedPoisson(nx=LAYOUT_NX, dim=3, order=1, dtype=torch.float64,
                        device=group.device)
    step, args = m.spmd_step(group, maxiter=maxiter)
    x_rep, res = step(*args)
    jstep, sargs, merge = m.spmd_step_sharded(group, maxiter=maxiter)
    xi, xs, res_sh = jstep(*sargs)
    x_dof = merge(xi, xs)
    dst = m.dia_structure()
    V, _ = m.assemble_vals_lattice(m.vertices, m.lset, dst)
    x_lat, res_lat, ls, _ = layout_c(m, dst, V, group, maxiter, 1e-8)
    out = {"ne": m.mesh.ne, "ndof": m.ndof, "halo_dofs": int(xs.numel())}
    if group.rank == 0:
        tol = 1e-5
        x_one, res_one = single_apply_cg(m, maxiter)
        x_lat1, _ = single_dia_cg(m, dst, V, maxiter, 1e-8)
        out.update(d_rep=_rel(x_rep, x_one), d_dof=_rel(x_dof, x_one),
                   d_lat=_rel(x_lat, x_lat1), res=float(res),
                   res_sh=float(res_sh), res_one=float(res_one),
                   res_lat=float(res_lat), H=ls.H,
                   halo_lat=2 * ls.H * ls.plane)
        print(f"dryrun_multichip({n}): ne={m.mesh.ne} ndof={m.ndof} "
              f"halo_dofs={out['halo_dofs']} "
              f"({100.0 * out['halo_dofs'] / m.ndof:.1f}% of ndof) "
              f"res_repl={out['res']:.3e} res_dofsharded={out['res_sh']:.3e} "
              f"res_single={out['res_one']:.3e} "
              f"|repl-single|/|x|={out['d_rep']:.2e} "
              f"|dofsh-single|/|x|={out['d_dof']:.2e}", flush=True)
        print(f"dryrun_multichip({n}) lattice-DIA: H={ls.H} planes, "
              f"halo={out['halo_lat']} dofs/rank boundary "
              f"({100.0 * out['halo_lat'] / m.ndof:.1f}% of ndof) "
              f"res={out['res_lat']:.3e} |lat-single|/|x|={out['d_lat']:.2e}",
              flush=True)
        if not (out["d_rep"] < tol and out["d_dof"] < tol
                and out["d_lat"] < tol):
            raise AssertionError(f"a layout != single rank: {out}")
    return out


def run_scaling(group):
    """The halo/payload table: layouts C and B at ``SCALE_NX`` on the first
    w ranks for each width w <= world size, each held against the
    single-rank solve (``SCALE_ITERS`` fixed CG iterations, 1e-5).
    Payload = bytes the collectives of one CG iteration move, counted by
    the group.  Returns rank 0's rows."""
    from ..models.poisson import UnfittedPoisson
    from ..solvers.krylov import cg

    nx, iters = SCALE_NX, SCALE_ITERS
    widths = [w for w in WIDTHS if w <= group.world_size]
    m = UnfittedPoisson(nx=nx, dim=3, order=1, dtype=torch.float64,
                        device=group.device)
    dst = m.dia_structure()
    V, _ = m.assemble_vals_lattice(m.vertices, m.lset, dst)
    tol = 1e-5
    rows = []
    ref_lat = ref_dof = None
    if group.rank == 0:
        ref_lat, _ = single_dia_cg(m, dst, V, iters, 0.0)
        ref_dof, _, _ = cg(m.operator(m.vertices, m.lset), indicator(m),
                           maxiter=iters, tol=0.0)
        _say(group, f"halo scaling table (nx={nx}, ne={m.mesh.ne}, "
                    f"ndof={m.ndof}, {iters}-iter CG, payload = bytes the "
                    "collectives of one CG iteration move, all ranks):")
        _say(group, "  width | layout       | halo dofs | %ndof | "
                    "payload/iter | |x-single|/|x|")
    for w in widths:
        sub = group.subgroup(w)
        if sub is None:
            continue
        x_lat, _, ls, lat_bytes = layout_c(m, dst, V, sub, iters, 0.0)
        jstep, sargs, merge = m.spmd_step_sharded(sub, maxiter=iters)
        b0 = sub.bytes
        xi, xs, _ = jstep(*sargs)
        moved = torch.tensor([lat_bytes, sub.bytes - b0], dtype=torch.float64,
                             device=sub.device)
        lat_bytes, dof_bytes = sub.all_reduce(moved).tolist()  # all ranks
        x_dof = merge(xi, xs)
        if sub.rank == 0:
            halo = 2 * ls.H * ls.plane
            dl = _rel(x_lat, ref_lat)
            dd = _rel(x_dof, ref_dof)
            for layout, hd, pay, d in (
                    ("lattice-slab", halo, lat_bytes, dl),
                    ("dof-sharded", int(xs.numel()), dof_bytes, dd)):
                per_iter = pay / iters
                rows.append({"width": w, "layout": layout, "halo": hd,
                             "payload_per_iter": per_iter, "rel": d})
                print(f"  {w:5d} | {layout:12s} | {hd:9d} | "
                      f"{100.0 * hd / m.ndof:5.1f} | {per_iter:12.0f} | "
                      f"{d:.2e}", flush=True)
            if not (dl < tol and dd < tol):
                raise AssertionError(f"width {w}: lattice {dl}, dof {dd}")
    return rows


def run_layout_d(group):
    """Layout D at ``D_NX`` on the first w ranks for each width w <= world
    size: the slab rows bitwise equal to the whole table's, the true
    relative residual below 1e-8 and the solution within 1e-6 of the
    single-rank pipeline's.  Returns rank 0's rows."""
    from ..models.poisson import UnfittedPoisson

    nx = D_NX
    widths = [w for w in WIDTHS if w <= group.world_size]
    m = UnfittedPoisson(nx=nx, dim=3, order=1, dtype=torch.float64,
                        device=group.device)
    dst = m.dia_structure()
    x1, res1, V = single_pipeline_d(m, dst)
    bn = float(torch.linalg.vector_norm(indicator(m, dst).double()))
    rows = []
    if float(res1) / bn >= 1e-8:
        raise AssertionError(f"single-rank pipeline D: {float(res1) / bn}")
    _say(group, f"end-to-end sharded flagship (nx={nx}, ne={m.mesh.ne}, "
                "slab assembly + Nitsche + ghost penalty + cg_ir):")
    _say(group, "  width | layout         | true-res/|b| | |x-single|/|x| | "
                "slab rows == table rows")
    for w in widths:
        sub = group.subgroup(w)
        if sub is None:
            continue
        x, res, Vl, ls = layout_d(m, dst, sub)
        lo = ls.lo
        hi = min(lo + ls.Lp, ls.n)
        same = torch.tensor([int(torch.equal(Vl[:, :max(hi - lo, 0)],
                                             V[:, lo:hi]))],
                            device=Vl.device)
        sub.all_reduce(same)
        if sub.rank == 0:
            rel = float(res) / bn
            dl = _rel(x, x1)
            rows.append({"width": w, "rel_res": rel, "rel": dl,
                         "bitwise_ranks": int(same)})
            print(f"  {w:5d} | slab-e2e       | {rel:12.2e} | {dl:14.2e} | "
                  f"{int(same)}/{w} ranks", flush=True)
            if not (rel < 1e-8 and dl < 1e-6 and int(same) == w):
                raise AssertionError(f"layout D width {w}: {rows[-1]}")
    return rows


def _dryrun_rank(group):
    out = {"layouts": run_layouts(group)}
    if group.world_size > 1:
        out["scaling"] = run_scaling(group)
        out["layout_d"] = run_layout_d(group)
    return out


def dryrun_multichip(n, device=None):
    """The layouts on ``n`` ranks (``spawn_ranks``: one NCCL rank per card
    by default, raising when fewer than n cards are visible; gloo ranks on
    the CPU with ``device="cpu"``), the counterpart of the reference's
    ``dryrun_multichip``: layouts A, B and C at nx=12 held against the
    single-rank solve and, with more than one rank, the nx=24 halo/payload
    table over 2/4/8 ranks and layout D at nx=15.  Rank 0 prints; returns
    its numbers."""
    return spawn_ranks(n, _dryrun_rank, device=device)[0]
