"""The whole flagship slice of the PyTorch port against the JAX flagship.

JAX side, as bench.py:195-266 builds it: ``UnfittedPoisson`` ->
``dia_structure`` -> ``assemble_vals_lattice`` -> ``krylov.cg`` on
``dia_matvec`` with the Jacobi preconditioner.  Port side: the same path,
built from its own state, ending in ``dia_cg_fused`` on the CPU.  nx=8; f64
for 50 iterations to rel 1e-9, f32 for 12 iterations to rel 5e-5
(reduction-order roundoff, as tests/test_pallas_cg.py:79-82).  The residual
difference is measured against ||b||, as tests/test_pallas_cg.py:82 does: 50
f64 iterations at nx=8 drive the residual itself down to roundoff (~1e-23).

The later slices end to end, on the CPU: the native-f64 flagship (f64
Jacobi-PCG and ``cg_ir`` against the JAX package's, 1e-8), the flagship
written as a weak form against the hand-written model's DIA operator in
both packages (the reference's own two paths agree to ~4e-15 at nx=6; both
are held to 1e-12), and the checks of ``chip_smoke.py``'s lattice-multigrid,
native-f64 and public-API phases at small nx.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu.models.poisson import UnfittedPoisson as JaxPoisson
from ngsxfem_tpu.solvers.krylov import cg as jax_cg
from ngsxfem_tpu.solvers.krylov import cg_ir as jax_cg_ir
from ngsxfem_tpu.solvers.sparse import dia_matvec as jax_dia_matvec
from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
from ngsxfem_tpu_torch.solvers.dia_cg import dia_cg_fused
from ngsxfem_tpu_torch.solvers.krylov import cg, cg_ir
from ngsxfem_tpu_torch.solvers.sparse import dia_matvec

NX = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: under ``-n 6`` the workers'
    thread pools contend, and the port's small-tensor Krylov loops slow
    down 8x with torch's default threads (the phase-16 rehearsal on an
    8-core CPU with seven cores busy: 52.6 s, against 6.8 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_flagship(dtype, iters):
    m = JaxPoisson(nx=NX, dim=3, order=1, dtype=dtype)
    st = m.dia_structure()
    offs = st["offsets"]
    k0 = int(np.searchsorted(offs, 0))
    V, ncut = m.assemble_vals_lattice(m.vertices, m.lset, st)
    b = jnp.asarray(np.where(m.active_dofs[st["perm_inv"]], 1.0, 0.0),
                    dtype=dtype)
    dinv = jnp.where(jnp.abs(V[k0]) > 1e-30, 1.0 / V[k0], 1.0)
    x, _, res = jax_cg(lambda v: jax_dia_matvec(offs, V, v), b,
                       M=lambda r: dinv * r, maxiter=iters, tol=0.0)
    return np.asarray(x), float(res), int(ncut), float(jnp.linalg.norm(b))


def _port_flagship(dtype, iters):
    m = UnfittedPoisson(nx=NX, dim=3, order=1, dtype=dtype, device="cpu")
    st = m.dia_structure()
    offs = st["offsets"]
    k0 = int(np.searchsorted(offs, 0))
    V, ncut = m.assemble_vals_lattice(m.vertices, m.lset, st)
    b = torch.as_tensor(np.where(m.active_dofs[st["perm_inv"]], 1.0, 0.0),
                        dtype=dtype)
    dinv = torch.where(V[k0].abs() > 1e-30, 1.0 / V[k0], 1.0)
    x, res = dia_cg_fused(offs, V, b, dinv, iters)
    return x.numpy(), float(res), int(ncut)


@pytest.mark.parametrize("prec,iters,tol", [("f64", 50, 1e-9),
                                            ("f32", 12, 5e-5)])
def test_slice_matches_jax_flagship(prec, iters, tol):
    jdt, tdt = {"f64": (jnp.float64, torch.float64),
                "f32": (jnp.float32, torch.float32)}[prec]
    xj, rj, nj, bn = _jax_flagship(jdt, iters)
    xt, rt, nt = _port_flagship(tdt, iters)
    assert nt == nj
    assert xt.dtype == xj.dtype
    assert np.linalg.norm(xt - xj) <= tol * np.linalg.norm(xj)
    assert abs(rt - rj) <= tol * bn


def test_native_f64_slice_matches_jax():
    """f64 lattice assembly, f64 Jacobi-PCG and cg_ir on the same system,
    each package from its own state."""
    mj = JaxPoisson(nx=NX, dim=3, order=1, dtype=jnp.float64)
    stj = mj.dia_structure()
    offs = stj["offsets"]
    k0 = int(np.searchsorted(offs, 0))
    Vj, _ = mj.assemble_vals_lattice(mj.vertices, mj.lset, stj)
    bj = jnp.asarray(np.where(mj.active_dofs[stj["perm_inv"]], 1.0, 0.0))
    dj = jnp.where(jnp.abs(Vj[k0]) > 1e-30, 1.0 / Vj[k0], 1.0)
    Vj32, dj32 = Vj.astype(jnp.float32), dj.astype(jnp.float32)
    xj, kj, _ = jax_cg(lambda v: jax_dia_matvec(offs, Vj, v), bj,
                       M=lambda r: dj * r, maxiter=3000, tol=1e-12)
    xij, _ = jax_cg_ir(lambda v: jax_dia_matvec(offs, Vj32, v),
                       lambda v: jax_dia_matvec(offs, Vj, v), bj,
                       M=lambda r: dj32 * r, outer=4, inner=120)

    mt = UnfittedPoisson(nx=NX, dim=3, order=1, dtype=torch.float64,
                         device="cpu")
    stt = mt.dia_structure()
    Vt, _ = mt.assemble_vals_lattice(mt.vertices, mt.lset, stt)
    assert Vt.dtype == torch.float64
    bt = torch.as_tensor(np.asarray(bj))
    dt = torch.where(Vt[k0].abs() > 1e-30, 1.0 / Vt[k0], 1.0)
    Vt32, dt32 = Vt.float(), dt.float()
    mv64 = lambda v: dia_matvec(offs, Vt, v)
    xt, kt, _ = cg(mv64, bt, M=lambda r: dt * r, maxiter=3000, tol=1e-12)
    xit, rit = cg_ir(lambda v: dia_matvec(offs, Vt32, v), mv64, bt,
                     M=lambda r: dt32 * r, outer=4, inner=120)
    bn = float(torch.linalg.vector_norm(bt))
    assert float(torch.linalg.vector_norm(bt - mv64(xt))) <= 1e-10 * bn
    assert float(rit) <= 1e-10 * bn
    assert abs(kt - int(kj)) <= 1
    nrm = np.linalg.norm(np.asarray(xj))
    assert np.linalg.norm(xt.numpy() - np.asarray(xj)) <= 1e-8 * nrm
    assert np.linalg.norm(xit.numpy() - np.asarray(xij)) <= 1e-8 * nrm
    assert np.linalg.norm(xit.numpy() - xt.numpy()) <= 1e-8 * nrm


def _forms_vs_model(N, P, dtype, kw, arr, matvec, nx):
    """rel error on active dofs between the flagship written as a weak form
    on the hand-written model's mesh and level set, and the model's DIA
    operator, over three seeded vectors."""
    m = P(nx=nx, dim=3, order=1, dtype=dtype, **kw)
    d = m.dia_structure()
    V, _ = m.assemble_vals_lattice(m.vertices, m.lset, d)
    mesh = m.mesh
    lsetp1 = N.GridFunction(N.H1(mesh, order=1, **kw))
    lsetp1.vec.data = arr(m.lset_np[m.p1dof2vertex])
    ci = N.CutInfo(mesh, lsetp1)
    hasneg, hasif = ci.GetElementsOfType(N.HASNEG), ci.GetElementsOfType(N.IF)
    assert np.array_equal(hasneg.np, m.active)
    Vh = N.H1(mesh, order=1, dgjumps=True, **kw)
    u, v = Vh.TnT()
    h = N.specialcf.mesh_size
    n = 1.0 / N.Norm(N.grad(lsetp1)) * N.grad(lsetp1)
    neg = {"levelset": lsetp1, "domain_type": N.NEG}
    iff = {"levelset": lsetp1, "domain_type": N.IF}
    a = N.BilinearForm(Vh)
    a += N.SymbolicBFI(neg, form=N.grad(u) * N.grad(v),
                       definedonelements=hasneg)
    a += N.SymbolicBFI(iff, form=-(N.grad(u) * n) * v - (N.grad(v) * n) * u
                       + m.lam_nitsche / h * u * v)
    a += N.SymbolicFacetPatchBFI(
        form=m.gamma_gp / (h * h) * (u - u.Other()) * (v - v.Other()),
        definedonelements=N.GetFacetsWithNeighborTypes(mesh, a=hasneg,
                                                       b=hasif))
    a.Assemble()
    act = m.active_dofs
    rng = np.random.default_rng(0)
    worst = 0.0
    for _ in range(3):
        xv = np.where(act, rng.standard_normal(m.ndof), 0.0)
        y_forms = np.asarray(a.mat * arr(xv))
        y_dia = np.asarray(matvec(d["offsets"], V,
                                  arr(xv[d["perm_inv"]])))[d["perm"]]
        worst = max(worst, np.linalg.norm((y_forms - y_dia)[act])
                    / np.linalg.norm(y_dia[act]))
    return worst


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_forms_operator_equals_handwritten_model(pkg):
    if pkg == "jax":
        rel = _forms_vs_model(J, JaxPoisson, jnp.float64, {}, jnp.asarray,
                              jax_dia_matvec, 6)
    else:
        rel = _forms_vs_model(T, UnfittedPoisson, torch.float64,
                              {"device": "cpu"}, torch.as_tensor, dia_matvec, 6)
    print(f"{pkg}: forms vs DIA operator on active dofs, nx=6: rel {rel:.3e}")
    assert rel <= 1e-12


def test_chip_smoke_new_phases_on_cpu(monkeypatch):
    """The checks of chip_smoke.py's lattice-multigrid, native-f64 and
    public-API phases, driven on the CPU at nx <= 16."""
    import chip_smoke as cs

    dev = torch.device("cpu")
    monkeypatch.setattr(cs, "NX", 16)
    monkeypatch.setattr(cs, "API_NX", (8, 4, 8, 16))
    monkeypatch.setattr(cs, "EOC_MIN", 1.7)
    model, struct, V, _, b, _, _ = cs.flagship(16, dev)
    levels = [cs.new_lattice_level(nx, dev, torch.float32) for nx in (4, 8)]
    levels.append(cs.lattice_level(model, struct, V))
    r32 = cs.lattice_mg(levels, torch.float32, dev)
    assert r32["iters"] <= 12 and r32["jacobi_iters"] > 2 * r32["iters"]
    again = cs.lattice_mg(levels, torch.float32, dev, jacobi=False)
    assert torch.equal(again["x"], r32["x"])
    f64 = cs.native_f64(dev, V, b)
    assert f64["pcg_rel"] <= 1e-10 and f64["ir_rel"] <= 1e-10
    lv64 = [cs.new_lattice_level(nx, dev, torch.float64) for nx in (4, 8)]
    lv64.append(cs.lattice_level(f64["model"], f64["struct"], f64["V"]))
    r64 = cs.lattice_mg(lv64, torch.float64, dev)
    assert abs(r64["iters"] - r32["iters"]) <= 1 and r64["true_rel"] <= 1e-8
    api = cs.public_api(T, dev, f64["model"], f64["struct"], f64["V"])
    assert api["cg_products"] == api["cg_iters"] + 1
    assert api["cg_launches"] == 0      # CPU tensors launch no kernel
    assert api["vs_model"] <= 1e-12 and api["dsol"] <= 1e-8
    # a failed check raises
    monkeypatch.setattr(cs, "LMG_MAX_ITERS", 2)
    with pytest.raises(RuntimeError, match="MG-CG took"):
        cs.lattice_mg(levels, torch.float32, dev, jacobi=False)


def test_chip_smoke_skeleton_phase_on_cpu(monkeypatch):
    """The checks of chip_smoke.py's phase 16 (DG, dn ghost penalty, cut
    Stokes with MINRES, Nitsche-XFEM, XFESpace), driven on the CPU at
    nx <= 16 (the card sizes cut to 16), the reference limits and rates
    set for those sizes (nx 8 -> 12 is no doubling)."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "DG_NX", (8, 12))
    monkeypatch.setattr(cs, "DN_NX", 8)
    monkeypatch.setattr(cs, "NXF_NX", 8)
    monkeypatch.setattr(cs, "NXF_LU_NX", 8)
    monkeypatch.setattr(cs, "ST_NX", (8, 12))
    monkeypatch.setattr(cs, "DG_RATE", 2.0)
    monkeypatch.setattr(cs, "ST_RATE", (2.0, 2.0))
    monkeypatch.setattr(cs, "DG_MAX", 0.05)
    monkeypatch.setattr(cs, "DN_MAX", 0.5)
    monkeypatch.setattr(cs, "NXF_MAX", 0.5)
    monkeypatch.setattr(cs, "ST_MAX", (0.05, 0.1))
    monkeypatch.setattr(cs, "BIG_NX", {"fictdom_dg_ghostpen": 16,
                                       "fictdom_dn_ghostpen": 16,
                                       "stokescutfem": 16, "nxfem": 16})
    sk = cs.skeleton_slice(T, torch.device("cpu"))
    for b in sk["bigs"]:
        assert b["products"] == b["iters"] + 1 and b["launches"] == 0
        assert b["true_rel"] <= 1e-8
    st = sk["stokes32"]
    assert st[2] <= 1e-8 and st[3] <= 1e-8 and st[4] <= 1e-8
    assert sk["nxfem_lu_cg"] <= 1e-8
    assert [b["kind"] for b in sk["bigs"]] == ["cg", "cg", "minres", "cg"]
    # a failed check raises
    monkeypatch.setattr(cs, "DN_MAX", 0.01)
    with pytest.raises(RuntimeError, match="dn ghost penalty"):
        cs.skeleton_slice(T, torch.device("cpu"))
