"""The parallel layouts of the PyTorch port (``ngsxfem_tpu_torch.parallel``)
on gloo ranks on the CPU, against the JAX package on its 8 virtual CPU
devices (tests/conftest.py) and against the port's single-rank results.

The ranks are spawned once per world size for the whole module
(``spawn_ranks``, a ``FileStore`` in a temporary directory); each runs
``_rank_job`` and rank 0 returns its results as numpy arrays.  The
tolerances are those of tests/test_parallel.py and tests/test_latticeshard.py:
the sharded steps within 1e-6 of the reference after 25 CG iterations and
1e-12 after one, the lattice-slab product within 1e-12 of the single-device
product (2, 4 and 8 ranks; 8 ranks at nx=12 relay the halo over two hops),
the sharded PCG within 1e-9, sharded ``Integrate`` within 1e-12.  A sharded
``Assemble`` (the space-time slab's too) equals the single-rank matrix bit
for bit, and the JAX package's to 1e-13 of its largest entry; layout D's
slab rows equal the whole DIA table's bit for bit.

JAX is imported inside the tests only: the spawned ranks import this module
to find ``_rank_job`` and must not start JAX.
"""
import numpy as np
import pytest
import torch

import ngsxfem_tpu_torch as T
from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
from ngsxfem_tpu_torch.parallel import (DofPartition, LatticeShard,
                                        backend_for, dryrun_multichip,
                                        element_chunks, shard_mesh,
                                        shard_space, spawn_ranks)
from ngsxfem_tpu_torch.parallel.dryrun import slab_rows
from ngsxfem_tpu_torch.solvers.krylov import cg

CPU = torch.device("cpu")
SPMD_NX = 4       # the flagship of the sharded steps (25 CG iterations
                  # reach ~3e-8 there: beyond, the partial solve amplifies
                  # rounding, 1.7e-6 between the packages' one-device
                  # solves at nx=16)
LAT_NX = 12       # nv1 = 13: 8 ranks hold 2 planes each, the halo 3
SLAB_NX = 15      # layout D (nv1 = 16 planes)
WORLDS = (2, 4, 8)


def _lset_2d(T_, nx):
    mesh = T_.MakeStructured2DMesh(quads=False, nx=nx, ny=nx)
    lset = T_.GridFunction(T_.H1(mesh, order=1, **_dev(T_)))
    T_.InterpolateToP1(T_.sqrt((T_.x - 0.5) ** 2 + (T_.y - 0.5) ** 2) - 0.3,
                       lset)
    return mesh, lset


def _dev(T_):
    return {"device": "cpu"} if T_ is T else {}


def integrate_case(T_, shard=None):
    """tests/test_parallel.py's sharded Integrate: x*y over NEG, order 4."""
    mesh, lset = _lset_2d(T_, 16)
    if shard is not None:
        shard(mesh, lset)
    return T_.Integrate({"levelset": lset, "domain_type": T_.NEG},
                        T_.x * T_.y, mesh, order=4)


def assemble_case(T_, shard=None):
    """tests/test_parallel.py's sharded assembly (nx=8, NEG grad.grad), and
    the load of x*y on the same domain."""
    mesh, lset = _lset_2d(T_, 8)
    Vh = T_.H1(mesh, order=1, **_dev(T_))
    if shard is not None:
        shard(mesh, lset, Vh)
    u, v = Vh.TnT()
    ld = {"levelset": lset, "domain_type": T_.NEG}
    a = T_.BilinearForm(Vh)
    a += T_.SymbolicBFI(ld, form=T_.grad(u) * T_.grad(v))
    a.Assemble()
    f = T_.LinearForm(Vh)
    f += T_.SymbolicLFI(ld, form=T_.x * T_.y * v)
    f.Assemble()
    return _np(a.mat.todense()), _np(f.vec.data)


def spacetime_case(T_, shard=None):
    """tests/test_parallel.py's space-time slab matrix (nx=8, P1 x P1)."""
    mesh = T_.MakeStructured2DMesh(quads=False, nx=8, ny=8)
    V = T_.H1(mesh, order=1, dgjumps=True, **_dev(T_))
    st = T_.SpaceTimeFESpace(V, T_.ScalarTimeFE(1))
    lset = T_.GridFunction(st)
    T_.SpaceTimeInterpolateToP1(
        T_.sqrt((T_.x - 0.4 - 0.2 * T_.tref) ** 2 + (T_.y - 0.5) ** 2) - 0.3,
        T_.tref, lset)
    lset_bot = T_.CreateTimeRestrictedGF(lset, 0.0)
    if shard is not None:
        shard(mesh, lset, V, st)
    u, v = st.TnT()
    h = T_.specialcf.mesh_size
    a = T_.BilinearForm(st)
    a += T_.SymbolicBFI({"levelset": lset, "domain_type": T_.NEG},
                        form=T_.dt(u) * v + T_.grad(u) * T_.grad(v),
                        time_order=2)
    a += T_.SymbolicBFI({"levelset": lset_bot, "domain_type": T_.NEG},
                        form=T_.fix_t(u, 0) * T_.fix_t(v, 0))
    a += T_.SymbolicFacetPatchBFI(
        form=1.0 / (h * h) * (u - u.Other()) * (v - v.Other()),
        time_order=1)
    a.Assemble()
    return _np(a.mat.todense())


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _lattice(nx):
    m = UnfittedPoisson(nx=nx, dim=3, order=1, dtype=torch.float64,
                        device=CPU)
    dst = m.dia_structure()
    V, _ = m.assemble_vals_lattice(m.vertices, m.lset, dst)
    return m, dst, V


def _rank_job(group):
    """Every check's sharded run on this rank, and rank 0's single-rank
    runs in the same process.  Returns rank 0's numpy results (None on the
    other ranks) and, from every rank, whether its layout-D rows equal the
    whole table's."""
    n, r = group.world_size, group.rank
    out = {}

    m = UnfittedPoisson(nx=SPMD_NX, dim=3, order=1, dtype=torch.float64,
                        device=CPU)
    for it in (25, 1):
        step, args = m.spmd_step(group, maxiter=it)
        x, res = step(*args)
        out[f"A{it}"] = (_np(x), float(res))
        jstep, sargs, merge = m.spmd_step_sharded(group, maxiter=it)
        xi, xs, res_sh = jstep(*sargs)
        out[f"B{it}"] = (merge(xi, xs), float(res_sh), int(xs.numel()))

    ml, dst, V = _lattice(LAT_NX)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(ml.ndof))
    ls = LatticeShard(dst["offsets"], LAT_NX + 1, 3, group)
    Vl = ls.pad_table(V)
    out["matvec"] = _np(ls.gather_x(ls.matvec(Vl, ls.pad_x(x))))
    out["H_L"] = (ls.H, ls.L)
    k0 = int(np.searchsorted(dst["offsets"], 0))
    dinv = torch.where(V[k0].abs() > 1e-30, 1.0 / V[k0], 1.0)
    b = torch.as_tensor(np.where(ml.active_dofs[dst["perm_inv"]], 1.0, 0.0))
    xs_, _, _ = cg(lambda z: ls.matvec(Vl, z), ls.pad_x(b),
                   M=lambda q: ls.pad_x(dinv) * q, maxiter=400, tol=1e-10,
                   dot=ls.dot)
    out["pcg"] = _np(ls.gather_x(xs_))

    def shard_all(mesh, *spaces):
        shard_mesh(mesh, group)
        for sp in spaces:
            shard_space(sp.space if hasattr(sp, "vec") else sp, group)

    out["integrate"] = integrate_case(T, shard_all)
    out["assemble"] = assemble_case(T, shard_all)
    out["spacetime"] = spacetime_case(T, shard_all)
    if r == 0:  # the single-rank results, in this process
        out["integrate1"] = integrate_case(T)
        out["assemble1"] = assemble_case(T)
        out["spacetime1"] = spacetime_case(T)

    md = UnfittedPoisson(nx=SLAB_NX, dim=3, order=1, dtype=torch.float64,
                         device=CPU)
    dd = md.dia_structure()
    Vd, _ = md.assemble_vals_lattice(md.vertices, md.lset, dd)
    lsd = LatticeShard(dd["offsets"], SLAB_NX + 1, 3, group)
    rows = slab_rows(md, dd, lsd)
    hi = min(lsd.lo + lsd.Lp, lsd.n)
    same = torch.equal(rows[:, :max(hi - lsd.lo, 0)], Vd[:, lsd.lo:hi]) \
        and not rows[:, max(hi - lsd.lo, 0):].any()
    return {"rank": r, "slab_rows_equal": bool(same),
            **(out if r == 0 else {})}


@pytest.fixture(scope="module")
def ranks():
    """``_rank_job`` on 2, 4 and 8 gloo ranks: {world size: results}."""
    return {n: spawn_ranks(n, _rank_job, device="cpu") for n in WORLDS}


@pytest.fixture(scope="module")
def jax_spmd():
    """The JAX package's sharded steps on its 8 virtual CPU devices, and
    one CG iteration of its single-device operator (tests/test_parallel.py)."""
    import jax
    import jax.numpy as jnp
    from ngsxfem_tpu.models.poisson import UnfittedPoisson as JaxPoisson
    from ngsxfem_tpu.parallel.sharding import virtual_cpu_devices
    from ngsxfem_tpu.solvers.krylov import cg as jcg

    devs = virtual_cpu_devices()
    m = JaxPoisson(nx=SPMD_NX, dim=3, order=1, dtype=jnp.float64)
    step, args = m.spmd_step(devices=devs)
    x_rep, res_rep = step(*args)
    jstep, sargs, merge = m.spmd_step_sharded(devices=devs, maxiter=25)
    xi, xs, res_sh = jstep(*sargs)
    b = jnp.asarray(np.where(m.active_dofs, 1.0, 0.0))
    x1, _, _ = jcg(lambda z: m.apply(m.vertices, m.lset, z), b, maxiter=1,
                   tol=0.0)
    S = {n: m.spmd_step_sharded(devices=devs[:n], maxiter=1)[1][-1].size
         for n in (2, 4)}
    return {"A": np.asarray(x_rep), "res_A": float(res_rep),
            "B": merge(xi, xs), "res_B": float(res_sh), "x1": np.asarray(x1),
            "ndof": m.ndof, "S": S}


def test_dof_partition_matches_jax():
    """Every table of ``DofPartition`` equals the JAX package's bit for bit
    on the flagship's element and facet rows (plane-aligned chunks)."""
    from ngsxfem_tpu.parallel.halo import DofPartition as JaxPartition

    m = UnfittedPoisson(nx=8, dim=3, order=1, dtype=torch.float64,
                        device=CPU)
    e2d = m.space.el2dof_np
    fd = np.concatenate([e2d[m.gp_e1], e2d[m.gp_e2]], axis=1)
    x = np.random.default_rng(3).standard_normal(m.ndof)
    for n in (1, 2, 4, 8):
        ch = element_chunks(m.mesh.ne, n, planes=m.nx)
        rows, chunks = [e2d, fd], [ch, ch[m.gp_e1]]
        a, b = DofPartition(m.ndof, rows, chunks, n), \
            JaxPartition(m.ndof, rows, chunks, n)
        for name in ("shared", "sh_ids", "Ni", "int_ids", "loc", "owner"):
            assert np.array_equal(getattr(a, name), getattr(b, name)), name
        assert (a.S, a.Ni_max) == (b.S, b.Ni_max)
        assert np.array_equal(a.localize_rows(e2d, ch),
                              b.localize_rows(e2d, ch))
        xi, xs = a.split_vector(x)
        yi, ys = b.split_vector(x)
        assert np.array_equal(xi, yi) and np.array_equal(xs, ys)
        assert np.array_equal(a.merge_vector(xi, xs), x)
    with pytest.raises(ValueError):
        DofPartition(4, [np.array([[0, -1]])], [np.zeros(1, np.int32)], 1)


@pytest.mark.parametrize("n", (2, 4))
def test_spmd_step_matches_jax(ranks, jax_spmd, n):
    """Layout A (element-sharded, ``spmd_step``) on n ranks against the JAX
    package's on 8 devices: 1e-6 after 25 iterations, 1e-12 after one."""
    res = ranks[n][0]
    x25, r25 = res["A25"]
    assert np.abs(x25 - jax_spmd["A"]).max() < 1e-6
    assert abs(r25 - jax_spmd["res_A"]) < 1e-8
    assert np.abs(res["A1"][0] - jax_spmd["x1"]).max() < 1e-12


@pytest.mark.parametrize("n", (2, 4))
def test_spmd_step_sharded_matches_jax(ranks, jax_spmd, n):
    """Layout B (dof-sharded, ``spmd_step_sharded``): the halo buffer is a
    layer, not ndof; 1e-6 of the JAX package's after 25 iterations and of
    layout A, 1e-12 of one CG iteration after one."""
    res = ranks[n][0]
    x25, r25, S = res["B25"]
    # a layer at two ranks; at four every slab of nx=4 is one plane wide
    assert S == jax_spmd["S"][n] and S < jax_spmd["ndof"] / (2 if n == 2 else 1)
    assert np.abs(x25 - jax_spmd["B"]).max() < 1e-6
    assert np.abs(x25 - res["A25"][0]).max() < 1e-6
    assert abs(r25 - jax_spmd["res_B"]) < 1e-8
    assert np.abs(res["B1"][0] - jax_spmd["x1"]).max() < 1e-12


@pytest.fixture(scope="module")
def lattice_ref():
    """The JAX package's single-device DIA product and Jacobi-PCG on the
    port's nx=12 table (tests/test_latticeshard.py)."""
    import jax
    import jax.numpy as jnp
    from ngsxfem_tpu.solvers.krylov import cg as jcg
    from ngsxfem_tpu.solvers.sparse import dia_matvec as jdia

    m, dst, V = _lattice(LAT_NX)
    Vj = jnp.asarray(V.numpy())
    x = jnp.asarray(np.random.default_rng(0).standard_normal(m.ndof))
    k0 = int(np.searchsorted(dst["offsets"], 0))
    dinv = 1.0 / jnp.where(jnp.abs(Vj[k0]) > 1e-30, Vj[k0], 1.0)
    b = jnp.asarray(np.where(m.active_dofs[dst["perm_inv"]], 1.0, 0.0))
    mv = jax.jit(lambda z: jdia(dst["offsets"], Vj, z))
    x1, _, _ = jcg(mv, b, M=lambda r: dinv * r, maxiter=400, tol=1e-10)
    return {"y": np.asarray(mv(x)), "x": np.asarray(x1)}


@pytest.mark.parametrize("n", WORLDS)
def test_lattice_shard_matvec_and_pcg(ranks, lattice_ref, n):
    """``LatticeShard`` on n ranks: the product within 1e-12 of the JAX
    package's single-device product (8 ranks: H=3 halo planes against L=2
    slab planes, relayed over two hops), the sharded Jacobi-PCG within
    1e-9 of its single-device solve."""
    res = ranks[n][0]
    H, L = res["H_L"]
    assert (n != 8) or H > L, (H, L)
    assert np.abs(res["matvec"] - lattice_ref["y"]).max() < 1e-12
    assert np.abs(res["pcg"] - lattice_ref["x"]).max() < 1e-9


@pytest.fixture(scope="module")
def jax_forms():
    import ngsxfem_tpu as J

    return {"integrate": integrate_case(J), "assemble": assemble_case(J),
            "spacetime": spacetime_case(J)}


@pytest.mark.parametrize("n", (2, 4))
def test_sharded_integrate(ranks, jax_forms, n):
    """Element-sharded ``Integrate``: each rank integrates its chunk, the
    scalars are all-reduced: 1e-12 of one rank and of the JAX package."""
    res = ranks[n][0]
    assert abs(res["integrate"] - res["integrate1"]) < 1e-12
    assert abs(res["integrate"] - jax_forms["integrate"]) < 1e-12


@pytest.mark.parametrize("case", ("assemble", "spacetime"))
@pytest.mark.parametrize("n", (2, 4))
def test_sharded_assemble_bitwise(ranks, jax_forms, n, case):
    """Element-sharded ``BilinearForm``/``LinearForm.Assemble`` (and the
    space-time slab's, with its facet patches): bit for bit the single-rank
    matrix and vector, and within 1e-13 of the JAX package's largest
    entry."""
    res = ranks[n][0]
    got, one, ref = res[case], res[case + "1"], jax_forms[case]
    got, one, ref = ((g,) if case == "spacetime" else g
                     for g in (got, one, ref))
    for g, o, j in zip(got, one, ref):
        assert np.array_equal(g, o)
        assert np.abs(g - j).max() < 1e-13 * np.abs(j).max()


@pytest.mark.parametrize("n", WORLDS)
def test_layout_d_slab_rows_bitwise(ranks, n):
    """Layout D: every rank's slab rows, assembled from its planes and the
    exchanged halo planes, equal the whole table's rows bit for bit (8
    ranks on 16 planes: two planes each, the halo relayed)."""
    assert all(r["slab_rows_equal"] for r in ranks[n])


def test_dryrun_multichip_4():
    """``dryrun_multichip(4, device="cpu")`` (four gloo ranks): layouts A,
    B and C held against one rank, the nx=24 halo table over 2 and 4 ranks,
    layout D at nx=15 (its asserts run on rank 0)."""
    out = dryrun_multichip(4, device="cpu")
    lay = out["layouts"]
    assert lay["d_rep"] < 1e-5 and lay["d_dof"] < 1e-5 and lay["d_lat"] < 1e-5
    assert [r["width"] for r in out["scaling"]] == [2, 2, 4, 4]
    assert [r["bitwise_ranks"] for r in out["layout_d"]] == [2, 4]


def test_backends_and_chunks():
    """gloo on the CPU; NCCL without a card raises (nothing falls back); a
    mesh is unsharded until ``shard_mesh``; plane-aligned chunks need whole
    planes."""
    assert backend_for("cpu") == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            backend_for("cuda")
    mesh = T.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    assert getattr(mesh, "shard", None) is None
    assert element_chunks(8, 2).tolist() == [0, 0, 0, 0, 1, 1, 1, 1]
    with pytest.raises(ValueError):
        element_chunks(10, 2, planes=3)


def test_chip_smoke_phases_28_29_on_cpu(monkeypatch):
    """chip_smoke.py's phases 28-29 on the CPU at nx=8 (gloo at world size
    1; CPU tensors launch no kernel, so B2's launches and timings are the
    card's alone): the dry run through one spawned gloo rank; every
    layout's solve equals its single-device solve bit for bit, layout D's
    rows the whole table's; the host halo tables for 2, 4 and 8 ranks; the
    public-API flagship on a sharded mesh (``PAR_API_NX`` patched to 8):
    its stencil and PA operators, the PCG through the stencil and the
    ``Assemble`` + ``Inverse()`` solve bitwise the unsharded ones, each
    sharded operator built with one all-reduce; the stencil, compact and
    ELL routes within their limits, the Jacobi-CG on the compact table
    equal on the plain product."""
    import time

    import chip_smoke as cs

    monkeypatch.setattr(cs, "PAR_API_NX", 8)

    flagships = {}
    for dt in (torch.float32, torch.float64):
        m = UnfittedPoisson(nx=8, dim=3, order=1, dtype=dt, device=CPU)
        d = m.dia_structure()
        V, _ = m.assemble_vals_lattice(m.vertices, m.lset, d)
        flagships[dt] = (m, d, V)
    st = flagships[torch.float64][0].ell_structure()
    launches, b2, rows, halos, (one, sh) = cs.phases_28_29(
        CPU, time.perf_counter(), flagships, st)
    assert launches == 0 and b2 is None
    assert sh["launches"] == 0 and sh["path"] == one["path"]
    assert sh["products"] == one["products"] and sh["ndof"] == 729
    assert {k: c for k, (c, _) in sh["coll"].items()} == {
        "LinearForm.Assemble": 1, "stencil build": 1, "pa build": 1,
        "BilinearForm.Assemble": 1}
    assert all(c == 0 for c, _ in one["coll"].values())
    assert len(rows) == 6 and all(r["rel"] == 0.0 for r in rows)
    assert [h[0] for h in halos] == [2, 4, 8]
    assert all(h[2] == halos[0][2] for h in halos)  # a slab surface
