"""Matrix-free operators of the port (``BilinearForm.AssembleOperator``:
``PartialAssemblyOperator`` and ``LatticeStencilOperator``) against the JAX
package, on the cases of ``tests/test_operator.py`` and
``tests/test_stencilop.py``.

The same forms are assembled in both packages (JAX on the CPU in float64,
the port with tensors on the CPU) and the same seeded vectors applied:
``matvec`` and ``diagonal()`` agree with the JAX package's operator and
with the port's ``a.mat`` product to 1e-12 of the largest entry, the
stencil with the partial assembly to 5e-13 (relative 2-norm), the
per-offset stencil apply (the card's) with the plain one to 1e-13.  The
dense stencil tables equal a sequential ``np.add.at`` of the same triplets
bit for bit.  Four faults of the reference are pinned, each by a test of the
correct behaviour: an empty form is the zero operator; the stencil guard
takes the partial assembly under ``"auto"`` and raises under
``lattice=True``; ``lattice=True`` with different trial and test spaces
raises; the partial assembly's scatter is bitwise deterministic.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T
from ngsxfem_tpu.solvers.stencilop import lattice_dof_map as j_lattice_dof_map
from ngsxfem_tpu_torch.solvers.operator import PartialAssemblyOperator
from ngsxfem_tpu_torch.solvers.stencilop import (
    LatticeStencilOperator, lattice_dof_map, stencil_apply_offsets,
    stencil_apply_plain)

CPU = {"device": "cpu"}


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(a, b, tol=1e-12):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(initial=0.0), 1e-300)
    assert np.abs(a - b).max(initial=0.0) <= tol * scale, \
        np.abs(a - b).max() / scale


def _rel2(a, b):
    a, b = _np(a), _np(b)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) or 1.0)


def _fictdom(N, dev, dim=3, nx=6, order=2):
    if dim == 3:
        mesh = N.MakeStructured3DMesh(hexes=False, nx=nx, ny=nx, nz=nx)
        lev = N.sqrt((N.x - .5) ** 2 + (N.y - .5) ** 2 + (N.z - .5) ** 2) - .4
    else:
        mesh = N.MakeStructured2DMesh(quads=False, nx=nx, ny=nx)
        lev = N.sqrt((N.x - .5) ** 2 + (N.y - .5) ** 2) - 0.4
    lsetp1 = N.GridFunction(N.H1(mesh, order=1, **dev))
    N.InterpolateToP1(lev, lsetp1)
    ci = N.CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(N.HASNEG)
    hasif = ci.GetElementsOfType(N.IF)
    V = N.H1(mesh, order=order, dgjumps=True, **dev)
    u, v = V.TnT()
    h = N.specialcf.mesh_size
    nl = 1.0 / N.Norm(N.grad(lsetp1)) * N.grad(lsetp1)
    gp = N.GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif)
    a = N.BilinearForm(V)
    a += N.SymbolicBFI({"levelset": lsetp1, "domain_type": N.NEG},
                       form=N.grad(u) * N.grad(v), definedonelements=hasneg)
    a += N.SymbolicBFI({"levelset": lsetp1, "domain_type": N.IF},
                       form=-(N.grad(u) * nl) * v - (N.grad(v) * nl) * u
                       + 40.0 / h * u * v)
    a += N.SymbolicFacetPatchBFI(
        form=0.1 / (h * h) * (u - u.Other()) * (v - v.Other()),
        definedonelements=gp)
    return mesh, V, hasneg, a


@pytest.mark.parametrize("dim", [2, 3])
def test_operator_equals_assembled_matvec(dim):
    _, Vt, _, at = _fictdom(T, CPU, dim=dim)
    _, _, _, aj = _fictdom(J, {}, dim=dim)
    at.Assemble()
    ops = {"auto": at.AssembleOperator(), "pa": at.AssembleOperator(False)}
    assert isinstance(ops["auto"], LatticeStencilOperator)
    assert isinstance(ops["pa"], PartialAssemblyOperator)
    opj = aj.AssembleOperator()
    xv = np.random.default_rng(0).standard_normal(Vt.ndof)
    y_j = np.asarray(opj.matvec(jnp.asarray(xv)))
    d_j = np.asarray(opj.diagonal())
    y_mat = at.mat.ell().matvec(torch.as_tensor(xv))
    _close(y_mat, y_j)
    _close(at.mat.diagonal(), d_j)
    for op in ops.values():
        _close(op.matvec(torch.as_tensor(xv)), y_mat)
        _close(op.matvec(torch.as_tensor(xv)), y_j)
        _close(op.diagonal(), d_j)


def test_operator_pcg_solves_fictdom():
    """Jacobi-PCG driven through the operators alone (projected to the
    active dofs) reaches 1e-8 on the order-2 unfitted system, with the
    solution of the JAX package's operator."""
    _, V, hasneg, a = _fictdom(T, CPU, dim=3, nx=6, order=2)
    free = torch.as_tensor(T.GetDofsOfElements(V, hasneg).np)
    b = torch.where(free, 1.0, 0.0).to(torch.float64)
    sols = []
    for lattice in ("auto", False):
        op = a.AssembleOperator(lattice)
        d = op.diagonal()
        dinv = torch.where(d.abs() > 1e-30, 1.0 / d, 0.0)
        mv = lambda xx: torch.where(free, op.matvec(torch.where(free, xx, 0.0)),
                                    0.0)
        sol, _, _ = T.cg(mv, b, maxiter=500, tol=1e-9,
                         M=lambda r: torch.where(free, dinv * r, 0.0))
        res = float(torch.linalg.norm(mv(sol) - b) / torch.linalg.norm(b))
        assert res < 1e-8, res
        sols.append(sol)
    _close(sols[0], sols[1], 1e-7)


def test_operator_without_assemble():
    _, V, _, a = _fictdom(T, CPU, dim=2, nx=8, order=1)
    op = a.AssembleOperator()
    a.Assemble()
    xv = torch.as_tensor(np.random.default_rng(1).standard_normal(V.ndof))
    _close(op.matvec(xv), a.mat.ell().matvec(xv))


def _stokes(N, dev):
    mesh = N.MakeStructured2DMesh(quads=False, nx=8, ny=8,
                                  mapping=lambda a, b: (2 * a - 1, 2 * b - 1))
    lsetp1 = N.GridFunction(N.H1(mesh, order=1, **dev))
    N.InterpolateToP1(N.sqrt(N.x * N.x + N.y * N.y) - 0.7, lsetp1)
    ci = N.CutInfo(mesh, lsetp1)
    hasneg = ci.GetElementsOfType(N.HASNEG)
    hasif = ci.GetElementsOfType(N.IF)
    V = N.VectorH1(mesh, order=2, dgjumps=True, **dev)
    Q = N.H1(mesh, order=1, dgjumps=True, **dev)
    X = N.FESpace([V, Q])
    (u, p), (v, q) = X.TnT()
    h = N.specialcf.mesh_size
    nl = 1.0 / N.Norm(N.grad(lsetp1)) * N.grad(lsetp1)
    lam = 160 / h
    ba = N.GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif)
    ln = {"levelset": lsetp1, "domain_type": N.NEG}
    li = {"levelset": lsetp1, "domain_type": N.IF}
    a = N.BilinearForm(X)
    a += N.SymbolicBFI(ln, form=N.InnerProduct(N.grad(u), N.grad(v))
                       - N.div(v) * p - N.div(u) * q, definedonelements=hasneg)
    a += N.SymbolicBFI(li, form=-((N.grad(u) * nl) * v)
                       - ((N.grad(v) * nl) * u) + lam * (u * v)
                       + p * (nl * v) + q * (nl * u))
    a += N.SymbolicFacetPatchBFI(
        form=1.0 / (h * h) * ((u - u.Other()) * (v - v.Other())),
        definedonelements=ba)
    a += N.SymbolicFacetPatchBFI(
        form=-0.1 * ((p - p.Other()) * (q - q.Other())), definedonelements=ba)
    a += N.SymbolicBFI(ln, form=-1e-8 * p * q, definedonelements=hasneg)
    fl = N.LinearForm(X)
    fl += N.SymbolicLFI(ln, form=N.CoefficientFunction((1.0, 0.5)) * v,
                        definedonelements=hasneg)
    active = N.CompoundBitArray([N.GetDofsOfElements(V, hasneg),
                                 N.GetDofsOfElements(Q, hasneg)])
    return X, a, fl, active


def test_operator_minres_stokes_saddle_point():
    """MINRES on the compound Stokes operator (partial assembly: compound
    spaces form no lattice) reproduces the direct masked solve, and the
    operator equals the JAX package's."""
    X, a, fl, active = _stokes(T, CPU)
    a.Assemble()
    fl.Assemble()
    x_direct = _np(a.mat.Inverse(active) * fl.vec.data)
    op = a.AssembleOperator()
    assert op.kind == "pa" and a.operator_kind == "pa"
    x_mr = _np(T.MinResSolver(op, maxsteps=20000, tol=1e-12,
                              freedofs=active) * fl.vec.data)
    m = active.np
    rel = np.abs(x_direct - x_mr)[m].max() / np.abs(x_direct)[m].max()
    assert rel < 1e-6, rel
    _, aj, _, _ = _stokes(J, {})
    xv = np.random.default_rng(2).standard_normal(X.ndof)
    _close(op.matvec(torch.as_tensor(xv)),
           np.asarray(aj.AssembleOperator().matvec(jnp.asarray(xv))))


def _iso_form(N, dev, mesh, order):
    r = (N.sqrt(N.x * N.x + N.y * N.y + N.z * N.z) if mesh.dim == 3
         else N.sqrt(N.x * N.x + N.y * N.y))
    lsa = N.LevelSetMeshAdaptation(mesh, order=order, threshold=0.2,
                                   discontinuous_qn=True, **dev)
    lsa.CalcDeformation(r - 0.7)
    mesh.SetDeformation(lsa.deform)
    ci = N.CutInfo(mesh, lsa.lset_p1)
    hasneg = ci.GetElementsOfType(N.HASNEG)
    hasif = ci.GetElementsOfType(N.IF)
    Vh = N.H1(mesh, order=order, dgjumps=True, **dev)
    ba = N.GetFacetsWithNeighborTypes(mesh, a=hasneg, b=hasif)
    nl = 1.0 / N.Norm(N.grad(lsa.lset_p1)) * N.grad(lsa.lset_p1)
    u, v = Vh.TnT()
    h = N.specialcf.mesh_size
    a = N.BilinearForm(Vh)
    a += N.SymbolicBFI({"levelset": lsa.lset_p1, "domain_type": N.NEG},
                       form=N.grad(u) * N.grad(v), definedonelements=hasneg)
    a += N.SymbolicBFI({"levelset": lsa.lset_p1, "domain_type": N.IF},
                       form=-(N.grad(u) * nl) * v - (N.grad(v) * nl) * u
                       + 40.0 / h * u * v)
    a += N.SymbolicFacetPatchBFI(
        form=0.1 / (h * h) * (u - u.Other()) * (v - v.Other()),
        definedonelements=ba)
    return a, Vh


@pytest.mark.parametrize("order", [1, 2])
def test_stencil_matches_partial_assembly_3d(order):
    """The reference test's contract on its case (isoparametric fictdom on
    tets nx=6): the stencil equals the partial assembly, and the per-offset
    apply the plain one.  The partial assembly itself is held against the
    JAX package by test_operator_equals_assembled_matvec."""
    mesh = T.MakeStructured3DMesh(
        hexes=False, nx=6, ny=6, nz=6,
        mapping=lambda a, b, c: (2 * a - 1, 2 * b - 1, 2 * c - 1))
    try:
        a, Vh = _iso_form(T, CPU, mesh, order)
        op_st = a.AssembleOperator()
        op_pa = a.AssembleOperator(lattice=False)
        assert op_st.kind == "stencil" and op_pa.kind == "pa"
        x = torch.as_tensor(np.random.default_rng(3).standard_normal(Vh.ndof))
        y_st = op_st.matvec(x)
        assert _rel2(y_st, op_pa.matvec(x)) < 5e-13
        assert _rel2(op_st.diagonal(), op_pa.diagonal()) < 5e-13
        assert _rel2(stencil_apply_offsets(
            op_st.tables, op_st.offsets, op_st.reach, op_st.chan, op_st.fs,
            x), y_st) < 1e-13
    finally:
        mesh.UnsetDeformation()


def test_stencil_order2_2d_plain_laplace():
    ys = {}
    for N, dev in ((T, CPU), (J, {})):
        mesh = N.MakeStructured2DMesh(quads=False, nx=7, ny=5)
        Vh = N.H1(mesh, order=2, **dev)
        u, v = Vh.TnT()
        a = N.BilinearForm(Vh)
        a += N.SymbolicBFI(form=N.grad(u) * N.grad(v) + u * v)
        xv = np.sin(np.arange(Vh.ndof))
        if N is T:
            op_st = a.AssembleOperator()
            assert isinstance(op_st, LatticeStencilOperator)
            op_pa = a.AssembleOperator(lattice=False)
            x = torch.as_tensor(xv)
            ys["st"], ys["pa"] = op_st.matvec(x), op_pa.matvec(x)
            assert _rel2(ys["st"], ys["pa"]) < 5e-13
            ys["off"] = stencil_apply_offsets(
                op_st.tables, op_st.offsets, op_st.reach, op_st.chan,
                op_st.fs, x)
            assert _rel2(ys["off"], ys["st"]) < 1e-13
        else:
            ys["jax"] = np.asarray(a.AssembleOperator().matvec(
                jnp.asarray(xv)))
    _close(ys["st"], ys["jax"])


def test_unstructured_mesh_falls_back():
    from ngsxfem_tpu_torch.mesh.mesh import Mesh

    mesh = T.MakeStructured2DMesh(quads=False, nx=5, ny=5)
    V = mesh.vertices_np.copy()
    interior = ((V[:, 0] > 1e-9) & (V[:, 0] < 1 - 1e-9)
                & (V[:, 1] > 1e-9) & (V[:, 1] < 1 - 1e-9))
    V[interior] += 0.02 * np.random.default_rng(0).standard_normal(
        V[interior].shape)
    Vh = T.H1(Mesh(mesh.et, V, mesh.elements_np), order=2, **CPU)
    assert lattice_dof_map(Vh) is None
    u, v = Vh.TnT()
    a = T.BilinearForm(Vh)
    a += T.SymbolicBFI(form=T.grad(u) * T.grad(v))
    assert isinstance(a.AssembleOperator(), PartialAssemblyOperator)
    with pytest.raises(ValueError, match="lattice"):
        a.AssembleOperator(lattice=True)


def test_lattice_dof_map_equals_reference():
    for dim, order in ((2, 1), (2, 3), (3, 2)):
        maps = []
        for N, dev in ((T, CPU), (J, {})):
            mesh = (N.MakeStructured2DMesh(quads=False, nx=3, ny=4) if dim == 2
                    else N.MakeStructured3DMesh(hexes=False, nx=2, ny=2, nz=3))
            dof_map = j_lattice_dof_map if N is J else lattice_dof_map
            maps.append(dof_map(N.H1(mesh, order=order, **dev)))
        t, j = maps
        assert t["dims"] == j["dims"] and t["nchan"] == j["nchan"]
        assert np.array_equal(t["chan"], j["chan"])
        assert np.array_equal(t["site"], j["site"])


# -- the reference's faults, fixed in the port --------------------------------

def test_empty_form_is_zero_operator():
    """The JAX stencil build concatenates an empty list and raises on a form
    without integrals; the port returns the zero operator."""
    mesh = T.MakeStructured2DMesh(quads=False, nx=3, ny=3)
    V = T.H1(mesh, order=2, **CPU)
    for lattice in ("auto", True, False):
        op = T.BilinearForm(V).AssembleOperator(lattice)
        x = torch.ones(V.ndof, dtype=torch.float64)
        assert torch.equal(op.matvec(x), torch.zeros_like(x))
        assert torch.equal(op.diagonal(), torch.zeros_like(x))


def test_stencil_guard(monkeypatch):
    """The stencil tables are bounded (reach and bytes): past the bound
    ``"auto"`` takes the partial assembly and ``lattice=True`` raises."""
    mesh = T.MakeStructured2DMesh(quads=False, nx=4, ny=4)
    V = T.H1(mesh, order=2, **CPU)
    u, v = V.TnT()
    a = T.BilinearForm(V)
    a += T.SymbolicBFI(form=T.grad(u) * T.grad(v))
    assert a.AssembleOperator().kind == "stencil"
    from ngsxfem_tpu_torch.solvers import stencilop

    for key, val, why in (("STENCIL_MAX_BYTES", 1024, "bytes"),
                          ("STENCIL_MAX_REACH", 0, "reach")):
        with monkeypatch.context() as mp:
            mp.setattr(stencilop, key, val)
            op = a.AssembleOperator()
            assert op.kind == "pa" and a.operator_kind == "pa"
            with pytest.raises(ValueError, match=why):
                a.AssembleOperator(lattice=True)


def test_lattice_true_with_two_spaces_raises():
    """The JAX package silently takes the generic operator for
    ``lattice=True`` when the trial and test spaces differ; the port
    raises (and ``"auto"`` takes the partial assembly)."""
    mesh = T.MakeStructured2DMesh(quads=False, nx=3, ny=3)
    U = T.H1(mesh, order=2, **CPU)
    W = T.H1(mesh, order=2, **CPU)
    u, v = U.TrialFunction(), W.TestFunction()
    a = T.BilinearForm(trialspace=U, testspace=W)
    a += T.SymbolicBFI(form=u * v)
    with pytest.raises(ValueError, match="trial and test spaces differ"):
        a.AssembleOperator(lattice=True)
    op = a.AssembleOperator()
    a.Assemble()
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(U.ndof))
    assert op.kind == "pa"
    _close(op.matvec(x), a.mat.matvec(x))


def test_pa_scatter_deterministic():
    """The partial assembly adds its contributions in one fixed order (a
    ScatterPlan built once per operator, where the JAX package's TPU path
    scatter-adds): two applies, and the applies of two operators built
    apart, are bitwise equal, and equal the sequential sum of the stream to
    round-off."""
    _, V, _, a = _fictdom(T, CPU, dim=3, nx=4, order=2)
    op = a.AssembleOperator(lattice=False)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(V.ndof))
    y1, y2 = op.matvec(x), op.matvec(x)
    assert torch.equal(y1, y2)
    assert torch.equal(y1, a.AssembleOperator(lattice=False).matvec(x))
    assert len(op._plan.levels) > 1  # slots with more than CHUNK terms
    seq = np.zeros(V.ndof)
    for m, dm_v, dm_u in op.parts:
        ye = torch.matmul(m, x[dm_u].unsqueeze(-1)).reshape(-1)
        np.add.at(seq, dm_v.reshape(-1).numpy(), ye.numpy())
    _close(y1, seq, 1e-14)


def test_stencil_tables_equal_host_add_at():
    """The dense tables are the sequential sum of the triplet stream,
    bit for bit what ``np.add.at`` gives on the host."""
    from ngsxfem_tpu_torch.forms.assemble import _triplets

    _, V, _, a = _fictdom(T, CPU, dim=2, nx=6, order=2)
    op = a.AssembleOperator()
    trip = [_triplets(b) for b in a._elmat_batches()]
    vals = torch.cat([t[0] for t in trip]).numpy()
    rows = torch.cat([t[1] for t in trip]).numpy()
    cols = torch.cat([t[2] for t in trip]).numpy()
    dm = lattice_dof_map(V)
    r, span, nchan = op.reach, 2 * op.reach + 1, op.nchan
    d = dm["site"][cols] - dm["site"][rows]
    o = (d[:, 0] + r) * span + (d[:, 1] + r)
    present = np.unique(o)
    assert op.offsets == present.tolist() and len(present) < span ** 2
    fs = dm["site"][rows, 0] * op.dims[1] + dm["site"][rows, 1]
    acc = np.zeros((len(present), nchan, nchan, op.dims[0] * op.dims[1]))
    np.add.at(acc, (np.searchsorted(present, o), dm["chan"][rows],
                    dm["chan"][cols], fs), vals)
    assert np.array_equal(op.tables.reshape(acc.shape).numpy(), acc)
    # the plain apply walks the present combos in the JAX package's order
    assert op.meta == sorted(op.meta)
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(V.ndof))
    assert torch.equal(op.matvec(x), stencil_apply_plain(
        op.tables, op.meta, op.offsets, op.reach, op.chan, op.fs, x))


def test_chip_smoke_mf_phase_22_on_cpu(monkeypatch):
    """chip_smoke.py's phase 22 on the CPU (card == CPU becomes CPU == CPU),
    the circle EOC on nx = 2, 4, 8: every check of the phase runs."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "SUBDIV_EOC_NX", (2, 4, 8))
    cpu = torch.device("cpu")
    rows = cs.mf_parity(T, cpu)
    assert [r["label"] for r in rows][-1] == "laplace 2D P2 7x5"
    assert cs.subdiv_parity(T, cpu)["cases"] == 59
    assert cs.spaces_parity(T, cpu)["sfe_ndof"] == 92
    hd = cs.hdg_parity(T, cpu)
    assert hd[2][0][1] < cs.HDG_P2_MAX


def test_chip_smoke_mf_phases_on_cpu(monkeypatch):
    """chip_smoke.py's phases 22-23 end to end on the CPU with the sizes cut
    small: phase 22 on one form, phase 23 on the high_order systems at P2
    nx=4 and P3 nx=3 (built as phase 19 keeps them), the sphere at nx=8 and
    tracefem_hdg at nx=24 (CPU tensors launch no kernel, and on the CPU the
    default Inverse() is the host LU): every check runs, the kept systems
    are released."""
    import chip_smoke as cs
    from ngsxfem_tpu_torch.examples import fictdom3d

    for name, val in (("card", lambda: "CPU"), ("MF_PARITY", ((2, 2),)),
                      ("SUBDIV_EOC_NX", (2, 4, 8)), ("SUBDIV_BIG_NX", 8),
                      ("HDG_BIG_NX", (24,)), ("MF_PCG_ITERS", 10)):
        monkeypatch.setattr(cs, name, val)
    cpu = torch.device("cpu")
    iso = []
    for order, nx in ((2, 4), (3, 3)):
        parts = fictdom3d.system(nx=nx, order=order, device=cpu,
                                 isoparametric=True)
        mesh = parts[2].mesh
        parts[0].Assemble()
        parts[1].Assemble()
        iso.append({"label": f"P{order} nx={nx}", "system": parts,
                    "deformation": mesh.deformation})
        mesh.UnsetDeformation()
    launches, tables = cs.phases_22_23(T, cpu, 0.0, iso)
    assert launches == 0 and all("system" not in b for b in iso)
    assert [t["launches"] for t in tables] == [0, 0, 0]
    assert tables[-1]["table"] == "tracefem_hdg P2 nx=24 (host_lu)"
