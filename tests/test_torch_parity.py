"""Parity of the port with the JAX package's own acceptance suite.

``tools/torch_parity.py`` runs the JAX package's test files against the port.
The faults of the port that run found are held here against the JAX package,
on the same seeded numpy inputs (CPU, float64):

- ``Compress`` of the facet, HDiv, SFE and XFE spaces assembles
  ``element_boundary`` and volume forms: the compressed matrix equals the
  JAX package's uncompressed matrix restricted to the active dofs to 1e-12,
  with no dead rows.  The JAX package's own compressed matrix keeps the
  placeholder slots, so its dof 0 collects the inactive slots' values (a
  fault of the reference, pinned here and not copied);
- numpy vectors at the public solver and transfer entry points
  (``CGSolver``, ``Inverse`` for every method, ``MinResSolver``, the
  ``Prolongate``/``Restrict`` of the prolongation classes,
  ``LinearMGIterator``, ``MultiGridCL``, the matrices' products,
  ``CreateCutIntegrationRule``): bitwise equal to the same call with a
  tensor, and equal to the JAX package's result at its tests' tolerance;
- numpy dtypes where the JAX package takes them (``UnfittedPoisson``,
  ``prolongation_matrix``, ``set_default_dtype``);
- the ``BilinearForm::Assemble`` and ``LinearForm::Assemble`` timers;
- ``bisect_refine_trig``/``bisect_refine_tet`` return the JAX package's
  three values;
- ``examples.cutmg.run()`` without a card raises the port's own error.

It also holds, through the public API or with torch-typed inputs, the
behaviours that the JAX tests pin through private helpers or JAX objects
(the classes (b) and (c) of ``ROADMAP.md``'s parity table).
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ngsxfem_tpu as J
import ngsxfem_tpu_torch as T

CPU = {"device": "cpu"}


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _dense(a):
    return _np(a.mat.todense())


def _dev(P):
    return CPU if P is T else {}


# -- Compress of the facet-type spaces --------------------------------------

def _compress_case(P, kind):
    """(compressed space, base space, active mask, element_boundary)."""
    dev = _dev(P)
    if kind == "facet-tet":
        mesh = P.MakeStructured3DMesh(hexes=False, nx=2, ny=2, nz=2)
    else:
        mesh = P.MakeStructured2DMesh(quads=kind == "facet-quad", nx=3, ny=3)
    circle = (P.x - 0.5) ** 2 + (P.y - 0.5) ** 2 - 0.3 ** 2
    eb = True
    if kind.startswith("facet"):
        F = P.FacetFESpace(mesh, order=0 if kind == "facet-p0" else 1, **dev)
        fmask = np.zeros(mesh.nfacets, bool)
        fmask[mesh.facet2el_np[:, 1] >= 0] = True  # interior facets
        act = P.GetDofsOfFacets(F, P.BitArray(fmask)).np.copy()
    else:
        if kind == "hdiv":
            F = P.HDiv(mesh, order=0, **dev)
        elif kind == "sfe":
            F, eb = P.SFESpace(mesh, circle, order=1, **dev), False
        else:
            lset = P.GridFunction(P.H1(mesh, order=1, **dev))
            P.InterpolateToP1(circle, lset)
            F, eb = P.XFESpace(P.H1(mesh, order=1, **dev), lset), kind == "xfe-eb"
        act = np.zeros(F.ndof, bool)
        act[::2] = True
    return P.Compress(F, P.BitArray(act)), F, act, eb


def _mass(P, space, eb):
    u, v = space.TnT()
    form = (P.InnerProduct(u, v) + P.div(u) * P.div(v)
            if isinstance(space.base if hasattr(space, "base") else space,
                          P.HDiv) else u * v)
    a = P.BilinearForm(space)
    a += P.SymbolicBFI(form=form, element_boundary=eb)
    a.Assemble()
    return _dense(a)


@pytest.mark.parametrize("kind", ["facet-p1", "facet-p0", "facet-quad",
                                  "facet-tet", "hdiv", "sfe", "xfe",
                                  "xfe-eb"])
def test_compress_facet_type_spaces(kind):
    """tests/test_fem_review.py::test_compress_facetspace on the port, for
    every space that evaluates through its own basis hook: the compressed
    matrix is the JAX package's full matrix restricted to the active dofs
    (1e-12 of its largest entry), with no dead rows."""
    Tc, Tf, act, eb = _compress_case(T, kind)
    Jc, Jf, jact, _ = _compress_case(J, kind)
    assert np.array_equal(act, jact)
    assert Tc.ndof == int(act.sum())
    assert np.array_equal(Tc.el2dof_np, Jc.el2dof_np)
    got = _mass(T, Tc, eb)
    want = _mass(J, Jf, eb)[act][:, act]
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 1e-12 * scale
    assert (np.abs(got).sum(axis=1) > 1e-12).all()  # no dead rows
    if kind == "hdiv":  # the JAX package's compressed HDiv has no vdim
        with pytest.raises(TypeError):
            _mass(J, Jc, eb)
        return
    # the reference's fault: its placeholder slots all land on dof 0
    bad = np.abs(_mass(J, Jc, eb) - want) > 1e-12 * scale
    assert bad.any() and not bad[1:, 1:].any()


# -- numpy vectors at the solver and transfer entry points ------------------

def _mesh11(P, nx):
    return P.MakeStructured2DMesh(quads=False, nx=nx, ny=nx,
                                  mapping=lambda a, b: (2 * a - 1, 2 * b - 1))


@pytest.fixture(scope="module")
def cut_hierarchy():
    """The two-level cut hierarchy of tests/test_api_surface.py::
    test_linear_mg_iterator_solves (nx 4 and 8) in both packages, its
    multigrid, and a seeded numpy vector of the fine size."""
    from examples.cutmg import build_level as jbuild
    from ngsxfem_tpu_torch.examples.cutmg import build_level as tbuild

    out = {}
    for P, build in ((J, lambda m: jbuild(m, 1)),
                     (T, lambda m: tbuild(m, 1, "cpu"))):
        levels = [build(_mesh11(P, n)) for n in (4, 8)]
        spaces = [l[0] for l in levels]
        mats = [l[1] for l in levels]
        prols = [P.solvers.mg.prolongation_matrix(spaces[0], spaces[1],
                                                  **_dev(P))]
        smoothers = [None, P.CutFemSmoother(mats[1], freedofs=levels[1][3],
                                            if_dofs=levels[1][4])]
        mg = P.MultiGridCL(mats, prols, smoothers,
                           coarse_freedofs=levels[0][3])
        out[P] = dict(A=mats[1], free=levels[1][3], mg=mg, spaces=spaces)
    n = out[T]["A"].shape[0]
    out["b"] = np.random.default_rng(7).standard_normal(n)
    return out


def _solve(P, h, entry, b):
    A, free = h[P]["A"], h[P]["free"]
    if entry == "cgsolver":
        return P.CGSolver(A, freedofs=free, maxsteps=400, tol=1e-12) * b
    if entry == "inverse-card":  # the default on a matrix on the card
        return A.Inverse(free) * b
    if entry.startswith("inverse"):
        return A.Inverse(free, inverse=entry.partition(":")[2]) * b
    if entry == "minres":
        return P.MinResSolver(A, freedofs=free, maxsteps=2000,
                              tol=1e-12) * b
    if entry == "linear_mg_iterator":
        return P.LinearMGIterator(h[P]["mg"], A, freedofs=free, maxit=60,
                                  tol=1e-10) * b
    if entry == "multigrid_cl":
        return h[P]["mg"](b)
    if entry == "cutfem_smoother":
        return h[P]["mg"].smoothers[1].smooth(np.zeros_like(b), b, 3)
    if entry == "sparse_matvec":
        return A.matvec(b)
    if entry == "ell_matvec":
        return A.ell().matvec(b)
    raise AssertionError(entry)


# (entry, relative tolerance against the JAX package): the direct and
# product paths to rounding, the iterative ones at the JAX tests' own
# tolerances (test_model_review.py::test_inverse_method_dispatch 1e-6 for
# "cg", 1e-8 for the LU; test_regressions.py::test_cgsolver_ell_fast_path_runs
# and test_operator.py::test_operator_minres_stokes_saddle_point 1e-6)
SOLVE_ENTRIES = [
    ("cgsolver", 1e-6), ("inverse:cg", 1e-6), ("inverse-card", 1e-6),
    ("inverse:", 1e-8),
    ("inverse:sparsecholesky", 1e-8), ("inverse:umfpack", 1e-8),
    ("inverse:pardiso", 1e-8), ("inverse:masterinverse", 1e-8),
    ("minres", 1e-6), ("linear_mg_iterator", 1e-6), ("multigrid_cl", 1e-10),
    ("cutfem_smoother", 1e-10),
    ("sparse_matvec", 1e-13), ("ell_matvec", 1e-13),
]


@pytest.mark.parametrize("entry,tol", SOLVE_ENTRIES,
                         ids=[e for e, _ in SOLVE_ENTRIES])
def test_numpy_rhs_at_solver_entry_points(cut_hierarchy, entry, tol,
                                          monkeypatch):
    """A numpy right-hand side is converted once, at the entry, to a tensor
    on the operator's device and in its dtype: the result is bitwise the
    tensor call's, and equal to the JAX package's (which takes numpy).
    ``inverse-card`` is the default ``Inverse()`` of a matrix on the card
    (Jacobi-CG through the ELL view; the predicate ``sparse._on_card``
    monkeypatched, the tensors on the CPU)."""
    from ngsxfem_tpu_torch.solvers import sparse

    if entry == "inverse-card":
        monkeypatch.setattr(sparse, "_on_card", lambda mat: True)
    h, b = cut_hierarchy, cut_hierarchy["b"]
    vals = h[T]["A"].vals
    got = _solve(T, h, entry, b)
    assert torch.is_tensor(got) and got.dtype == vals.dtype
    same = _solve(T, h, entry, torch.as_tensor(b, dtype=vals.dtype,
                                               device=vals.device))
    assert torch.equal(got, same)
    want = np.asarray(_solve(J, h, entry, b))
    assert np.linalg.norm(_np(got) - want) <= tol * np.linalg.norm(want)


@pytest.mark.parametrize("cls", ["P1Prolongation", "P2Prolongation",
                                 "P2CutProlongation", "CompoundProlongation"])
def test_numpy_vectors_at_prolongations(cls):
    """tests/test_api_surface.py::test_p2_prolongation_classes on the port,
    with ``Restrict`` and the compound class: a numpy vector is bitwise the
    tensor's result, the JAX package's to 1e-12, and the constant maps to the
    constant to 1e-10."""
    order = 1 if cls in ("P1Prolongation", "CompoundProlongation") else 2
    outs = {}
    for P in (T, J):
        m1 = P.MakeStructured2DMesh(quads=False, nx=2, ny=2)
        m2 = P.MakeStructured2DMesh(quads=False, nx=4, ny=4)
        spaces = [P.H1(m, order=order, **_dev(P)) for m in (m1, m2)]
        if cls == "CompoundProlongation":
            prol = P.CompoundProlongation(P.FESpace(spaces[:1] * 2))
            for _ in range(2):
                prol.AddProlongation(P.P1Prolongation(m1))
            for s in spaces:
                prol.Update(P.FESpace([s, s]))
            nc, nf = 2 * spaces[0].ndof, 2 * spaces[1].ndof
        else:
            prol = getattr(P, cls)(m1)
            for s in spaces:
                prol.Update(s)
            nc, nf = spaces[0].ndof, spaces[1].ndof
        outs[P] = (prol, nc, nf)
    prol, nc, nf = outs[T]
    rng = np.random.default_rng(3)
    xc, xf = rng.standard_normal(nc), rng.standard_normal(nf)
    for name, vec in (("Prolongate", xc), ("Restrict", xf)):
        got = getattr(prol, name)(1, vec)
        assert torch.is_tensor(got) and got.dtype == torch.float64
        assert torch.equal(got, getattr(prol, name)(1, torch.as_tensor(vec)))
        want = np.asarray(getattr(outs[J][0], name)(1, vec))
        assert np.abs(_np(got) - want).max() <= 1e-12 * np.abs(want).max()
    ones = _np(prol.Prolongate(1, np.ones(nc)))
    assert np.abs(ones - 1.0).max() <= 1e-10


def test_numpy_values_in_create_cut_integration_rule():
    """tests/test_api_surface.py::test_create_cut_integration_rule_direct
    and tests/test_misc.py::test_single_trig_decomposition on the port's
    public ``CreateCutIntegrationRule`` with numpy vertex values: NEG 1/8,
    POS 3/8, interface sqrt(2)/2 to 1e-14, bitwise the tensor call's and
    the JAX package's weights to 1e-14."""
    vals = np.asarray([[-1.0, 1.0, 1.0]])
    rule = T.CreateCutIntegrationRule("trig", vals, 2, "OPTIMAL", **CPU)
    same = T.CreateCutIntegrationRule("trig", torch.as_tensor(vals), 2)
    for f in ("w", "w_if", "side", "pts"):
        assert torch.equal(getattr(rule, f), getattr(same, f))
    w, side = _np(rule.w), _np(rule.side)
    assert abs(w[side == int(T.NEG)].sum() - 0.125) < 1e-14
    assert abs(w[side == int(T.POS)].sum() - 0.375) < 1e-14
    assert abs(_np(rule.w_if).sum() - math.sqrt(2) / 2) < 1e-14
    jr = J.CreateCutIntegrationRule("trig", vals, 2, "OPTIMAL")
    assert np.abs(w - np.asarray(jr.w)).max() < 1e-14
    assert np.abs(_np(rule.w_if) - np.asarray(jr.w_if)).max() < 1e-14


def test_numpy_dtypes_at_entry_points():
    """``UnfittedPoisson``, ``prolongation_matrix`` and ``set_default_dtype``
    take a dtype numpy names, as the JAX package's do, and give what the
    torch dtype gives, bitwise."""
    from ngsxfem_tpu_torch.config import config
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson
    from ngsxfem_tpu_torch.solvers.mg import prolongation_matrix

    for np_dt, t_dt in ((np.float64, torch.float64), ("float32", torch.float32)):
        a = UnfittedPoisson(nx=3, dim=3, order=1, dtype=np_dt, **CPU)
        b = UnfittedPoisson(nx=3, dim=3, order=1, dtype=t_dt, **CPU)
        assert a.dtype is t_dt and a.lset.dtype is t_dt
        assert torch.equal(a.lset, b.lset)
    m1 = T.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    m2 = T.MakeStructured2DMesh(quads=False, nx=4, ny=4)
    Vs = [T.H1(m, order=1, **CPU) for m in (m1, m2)]
    P32 = prolongation_matrix(*Vs, dtype=np.float32, **CPU)
    assert P32.vals.dtype is torch.float32
    assert torch.equal(P32.vals, prolongation_matrix(
        *Vs, dtype=torch.float32, **CPU).vals)
    before = config.dtype
    try:
        T.set_default_dtype(np.dtype("float32"))
        assert config.dtype is torch.float32
    finally:
        config.dtype = before


# -- timers, refinement, the cutmg example ----------------------------------

def test_assembly_timers():
    """tests/test_misc.py::test_timers on the port: one ``Assemble`` of each
    form records its ``::Assemble`` timer once, inside an enclosing region,
    as the JAX package's does."""
    from ngsxfem_tpu.utils import timing as jt
    from ngsxfem_tpu_torch.utils import timing as tt

    keys = {}
    for P, tm in ((T, tt), (J, jt)):
        tm.ResetTimers()
        mesh = P.MakeStructured2DMesh(quads=False, nx=4, ny=4)
        V = P.H1(mesh, order=1, **_dev(P))
        u, v = V.TnT()
        a = P.BilinearForm(V)
        a += P.SymbolicBFI(form=u * v)
        f = P.LinearForm(V)
        f += P.SymbolicLFI(form=1.0 * v)
        with tm.region("outer"):
            a.Assemble()
            f.Assemble()
        t = tm.GetTimers()
        keys[P] = {k for k in t if k.endswith("::Assemble")}
        for k in ("BilinearForm::Assemble", "LinearForm::Assemble"):
            assert t[k][1] == 1
            assert t["outer"][0] >= t[k][0]
    assert keys[T] == keys[J] == {"BilinearForm::Assemble",
                                  "LinearForm::Assemble"}


@pytest.mark.parametrize("et", ["trig", "tet"])
def test_bisect_refine_returns_three_values(et):
    """``bisect_refine_trig``/``bisect_refine_tet`` return the JAX package's
    three values (tests/test_refine.py::test_tet_bisection_conformity unpacks
    three): vertices, elements and the boundary data equal to its output on
    that test's seeded marks (default_rng(0), 10% per round, four rounds),
    with the mesh's boundary ids passed in; ``Refine()`` takes the parent
    index from the private helpers and keeps the children's materials."""
    from ngsxfem_tpu.mesh import refine as jr
    from ngsxfem_tpu_torch.mesh import refine as tr

    if et == "tet":
        mesh = T.MakeStructured3DMesh(hexes=False, nx=3, ny=3, nz=3)
        fn, jfn, private = (tr.bisect_refine_tet, jr.bisect_refine_tet,
                            tr._bisect_tet)
    else:
        mesh = T.MakeStructured2DMesh(quads=False, nx=6, ny=6)
        fn, jfn, private = (tr.bisect_refine_trig, jr.bisect_refine_trig,
                            tr._bisect_trig)
    bc = {tuple(sorted(int(v) for v in mesh.facets_np[f])):
          int(mesh.bc_of_facet_np[f]) for f in mesh.boundary_facets_np}
    V, E = mesh.vertices_np.astype(np.float64), mesh.elements_np
    rng = np.random.default_rng(0)
    for _ in range(4):
        marks = rng.random(len(E)) < 0.1
        out, ref = fn(V, E, marks, bc), jfn(V, E, marks, bc)
        assert len(out) == len(ref) == 3
        assert np.array_equal(out[0], ref[0])
        assert np.array_equal(out[1], ref[1])
        assert out[2] == ref[2]
        parent = private(V, E, marks, bc)[3]
        assert len(parent) == len(out[1]) and parent.max() < len(E)
    # Refine() keeps the children's materials: each its parent's
    mat = rng.integers(1, 3, len(E)).astype(np.int32)
    m = T.MeshFromArrays(et, V, E, mat_of_el=mat)
    m.Refine(marks)
    assert np.array_equal(m.mat_of_el_np, mat[private(V, E, marks)[3]])


def test_cutmg_run_resolves_the_device_first(monkeypatch):
    """``examples.cutmg.run()`` with no device on a host without a card
    raises the port's own ``RuntimeError`` (``config.resolve_device``), not
    torch's ``AssertionError`` from ``torch.cuda.synchronize``."""
    from ngsxfem_tpu_torch.examples import cutmg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cutmg.run(nx0=4, levels=2, verbose=False)


# -- behaviours the JAX tests pin through private helpers (class c) ---------

def test_codim2_interface_on_skeleton_and_boundary():
    """tests/test_misc.py::test_codim2_if_on_skeleton_and_boundary through
    public forms: the IF line x=0.4 crosses 3 interior horizontal facets and
    4 diagonals (skeleton measure 7, each facet once) and the bottom and top
    boundary once each (2), in both packages."""
    for P in (T, J):
        mesh = P.MakeStructured2DMesh(quads=False, nx=4, ny=4)
        lset = P.GridFunction(P.H1(mesh, order=1, **_dev(P)))
        P.InterpolateToP1(P.x - 0.4, lset)
        ld = {"levelset": lset, "domain_type": P.IF}
        N = P.NumberSpace(mesh, **_dev(P))
        u, v = N.TnT()
        for kw, want in ((dict(skeleton=True), 7.0),
                         (dict(VOL_or_BND=P.BND), 2.0)):
            a = P.BilinearForm(N)
            a += P.SymbolicBFI(ld, form=u * v, **kw)
            a.Assemble()
            assert abs(_dense(a).sum() - want) < 1e-12, (P.__name__, kw)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_spacetime_skeleton_time_tensorized(k):
    """tests/test_spacetime.py::test_spacetime_skeleton_time_tensorized
    through a public form: tref^k over the interior skeleton of the 3x3 mesh
    times [0, 1] is |skeleton| / (k+1)."""
    meas = 12 * (1 / 3) + 9 * (math.sqrt(2) / 3)
    mesh = T.MakeStructured2DMesh(quads=False, nx=3, ny=3)
    N = T.NumberSpace(mesh, **CPU)
    u, v = N.TnT()
    a = T.BilinearForm(N)
    a += T.SymbolicBFI(form=T.tref ** k * u * v, skeleton=True, time_order=k)
    a.Assemble()
    assert abs(_dense(a).sum() - meas / (k + 1)) < 1e-12 * (k + 1)


def test_dn_skeleton_forms_match_reference():
    """tests/test_ghostpenalty.py::test_dn_exactness and tests/test_hdiv.py::
    test_dn_hdiv_exact through public skeleton forms: ``dn(u, k)`` of an
    order-3 H1 space (k = 1, 2, 3) and ``dn(u, 1, hdiv=True)`` of RT0, equal
    to the JAX package's matrices to 1e-12 of the largest entry, and the
    order-3 operator exact on x^3 + x y^2 (its k-th derivative weighted by
    the test functions)."""
    mats = {}
    for P in (T, J):
        mesh = P.MakeStructured2DMesh(quads=False, nx=3, ny=3)
        V = P.H1(mesh, order=3, dgjumps=True, **_dev(P))
        u, v = V.TnT()
        for k in (1, 2, 3):
            a = P.BilinearForm(V)
            a += P.SymbolicBFI(form=P.dn(u, k) * v, skeleton=True)
            a.Assemble()
            mats[P, k] = _dense(a)
        R = P.HDiv(mesh, order=0, **_dev(P))
        r, s = R.TnT()
        a = P.BilinearForm(R)
        a += P.SymbolicBFI(form=P.dn(r, 1, hdiv=True) * P.dn(s, 1, hdiv=True),
                           skeleton=True)
        a.Assemble()
        mats[P, "hdiv"] = _dense(a)
    for key in (1, 2, 3, "hdiv"):
        want = mats[J, key]
        assert np.abs(want).max() > 0
        assert np.abs(mats[T, key] - want).max() <= 1e-12 * np.abs(want).max()


# -- behaviours the JAX tests pin with JAX objects (class b), torch-typed ---

def test_compressed_gf_eval_masked_torch_inputs():
    """tests/test_fem_review.py::test_compressed_gf_eval_masked with torch
    inputs: a compressed GridFunction is 0 (value and gradient) on elements
    with no active dof, and its integral equals the JAX package's."""
    from ngsxfem_tpu_torch.cf.context import EvalCtx, eval_pure

    ints = {}
    for P in (T, J):
        mesh = P.MakeStructured2DMesh(quads=False, nx=4, ny=4)
        V = P.H1(mesh, order=1, **_dev(P))
        act = np.zeros(V.ndof, bool)
        act[V.el2dof_np[:4].ravel()] = True
        Vc = P.Compress(V, P.BitArray(act))
        gf = P.GridFunction(Vc)
        gf.vec.data = (torch.ones(Vc.ndof, dtype=torch.float64) if P is T
                       else np.ones(Vc.ndof))
        ints[P] = float(P.Integrate(cf=gf, mesh=mesh, order=2, **_dev(P)))
        if P is T:
            dead = np.nonzero(~act[V.el2dof_np].any(axis=1))[0]
            assert len(dead) > 0
            ctx = EvalCtx(mesh, torch.full((len(dead), 1, 2), 0.25,
                                           dtype=torch.float64),
                          elem_ids=torch.as_tensor(dead))
            assert torch.equal(eval_pure(gf, ctx), torch.zeros(len(dead), 1,
                                                               dtype=torch.float64))
            assert not eval_pure(T.grad(gf), ctx).any()
            assert ints[P] < mesh.ne
    assert abs(ints[T] - ints[J]) <= 1e-14


def test_timefixedcf_deformation_override_torch_inputs():
    """tests/test_cf_spacetime_review.py::
    test_timefixedcf_forwards_deformation_override with torch inputs:
    ``fix_t`` keeps the context's own deformation (x -> 1.25 x)."""
    from ngsxfem_tpu_torch.cf.context import EvalCtx, eval_pure

    mesh = T.MakeStructured2DMesh(quads=False, nx=2, ny=2)
    deform = T.GridFunction(T.VectorH1(mesh, order=1, **CPU))
    deform.Set(T.CoefficientFunction((0.25 * T.x, 0.0 * T.y)))
    ref = torch.tensor([[0.2, 0.3]], dtype=torch.float64).expand(mesh.ne, 1, 2)
    ctx = EvalCtx(mesh, ref, deformation=deform,
                  time=torch.zeros(mesh.ne, 1, dtype=torch.float64))
    got = eval_pure(T.fix_t(T.x + 0.0 * T.tref, 0.5), ctx)
    want = ctx.phys[..., 0]
    assert (got - want).abs().max() <= 1e-12
    plain = EvalCtx(mesh, ref, deformation=None).phys[..., 0]
    assert (want - plain).abs().max() > 1e-3


def test_skeleton_under_spacetime_deformation_torch_inputs():
    """tests/test_assemble_review.py::test_skeleton_under_spacetime_
    deformation with torch inputs: a time-constant space-time deformation
    gives the stationary skeleton mass matrix (1e-12)."""
    def skeleton_mass(mesh, **kw):
        V = T.H1(mesh, order=1, dgjumps=True, **CPU)
        u, v = V.TnT()
        a = T.BilinearForm(V)
        a += T.SymbolicBFI(form=u * v, skeleton=True, **kw)
        a.Assemble()
        return _dense(a)

    mesh = T.MakeStructured2DMesh(quads=False, nx=3, ny=3)
    Vd = T.VectorH1(mesh, order=1, **CPU)
    dstat = T.GridFunction(Vd)
    dstat.Set(T.CoefficientFunction((0.2 * T.x * T.y, 0.0 * T.y)))
    A_stat = skeleton_mass(mesh, deformation=dstat)
    W = T.SpaceTimeFESpace(Vd, T.ScalarTimeFE(1))
    dst = T.GridFunction(W)
    dst.vec.data = torch.cat([dstat.vec.data] * W.ndof_t)
    A_st = skeleton_mass(mesh, deformation=dst, time_order=2)
    assert np.abs(A_st - A_stat).max() < 1e-12


def test_facetspace_f32_tolerance_torch_inputs():
    """tests/test_fem_review.py::test_facetspace_f32_tolerance with torch
    inputs: the facet basis hook at float32 element-boundary points is not
    masked to zero."""
    from ngsxfem_tpu_torch.cf.context import EvalCtx

    mesh = T.MakeStructured2DMesh(quads=False, nx=3, ny=3)
    F = T.FacetFESpace(mesh, order=1, **CPU)
    fr = torch.tensor([[0.25, 0.0], [0.75, 0.0]], dtype=torch.float32)
    pctx = EvalCtx(mesh, fr.expand(mesh.ne, 2, 2).contiguous())

    class Proxy:
        op = "val"
        block_key = ("f", 0)
        space = F

    arr = F.proxy_factor_hook(Proxy(), None, pctx).arr
    assert arr.dtype == torch.float32 and arr.abs().max() > 0.4


def test_eps_guard_torch_inputs():
    """tests/test_regressions.py::test_eps_guard_reference_semantics with
    torch inputs: |v| < 1e-14 becomes +1e-14 whatever its sign."""
    from ngsxfem_tpu_torch.ops.straightcut import eps_guard

    out = _np(eps_guard(torch.tensor([[0.0, -5.5e-17, 3e-15],
                                      [-1.0, 2.0, -9.9e-15]],
                                     dtype=torch.float64)))
    np.testing.assert_allclose(out[0], [1e-14, 1e-14, 1e-14])
    np.testing.assert_allclose(out[1], [-1.0, 2.0, 1e-14])


def test_runtime_active_mask_torch_inputs():
    """tests/test_model_review.py::test_apply_and_rhs_use_runtime_active_mask
    with torch inputs: ``rhs`` at a moved level set marks that level set's
    active dofs, ``apply`` at the model's own level set is finite and at the
    moved one (outside the frozen ghost-penalty band) poisons."""
    from ngsxfem_tpu_torch.models.poisson import UnfittedPoisson

    m1 = UnfittedPoisson(nx=6, dim=3, order=1, dtype=torch.float64,
                         radius=0.35, **CPU)
    m2 = UnfittedPoisson(nx=6, dim=3, order=1, dtype=torch.float64,
                         radius=0.45, **CPU)
    b = m1.rhs(m1.vertices, m2.lset,
               lambda p: torch.ones(p.shape[:-1], dtype=p.dtype))
    act2 = m2.active_dof_mask(m2.lset)
    assert b[~act2].abs().max() == 0 and b[act2].abs().max() > 0
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(m1.ndof))
    assert torch.isfinite(m1.apply(m1.vertices, m1.lset, x)).all()
    assert torch.isnan(m1.apply(m1.vertices, m2.lset, x)).any()


def test_dnk_reference_scaled_sampling_torch_inputs():
    """tests/test_model_review.py::test_dnk_reference_scaled_sampling_exact
    with torch inputs: at h = 1/64 the order-3 directional derivative of x^3
    is 3 x^2 to 1e-9."""
    from ngsxfem_tpu_torch.cf.context import EvalCtx
    from ngsxfem_tpu_torch.forms.evaluate import _dnk_factor

    mesh = T.MakeStructured2DMesh(quads=False, nx=64, ny=64)
    V = T.H1(mesh, order=3, dgjumps=True, **CPU)
    E = mesh.ne
    ctx = EvalCtx(mesh, torch.full((E, 1, 2), 0.25, dtype=torch.float64),
                  normal=torch.tensor([1.0, 0.0],
                                      dtype=torch.float64).expand(E, 1, 2))
    arr = _np(_dnk_factor(mesh.et, 3, 1, ctx))
    gf = T.GridFunction(V)
    gf.Set(T.x * T.x * T.x)
    got = (arr[:, 0, :] * _np(gf.vec.data)[V.el2dof_np]).sum(axis=1)
    px = _np(ctx.phys[..., 0])[:, 0]
    assert np.abs(got - 3 * px ** 2).max() < 1e-9


def test_chip_smoke_phase_30_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 30 on the CPU at small sizes (fictdom3d nx=8,
    the P2 pair nx 4 -> 8, the band at nx=32): the numpy right-hand sides'
    solves and the numpy prolongation bitwise the tensor calls', the
    compressed facet assembly equal to itself on the CPU, its host-LU
    solve, both timers; CPU tensors launch no kernel, so every B2 count is
    0 here."""
    import time

    import chip_smoke as cs
    from ngsxfem_tpu_torch.examples import fictdom3d

    monkeypatch.setattr(cs, "PAR_API_NX", 8)
    monkeypatch.setattr(cs, "P30_P2_NX", 8)
    monkeypatch.setattr(cs, "P30_HDG_NX", 32)
    a, f, Vh, free, _ = fictdom3d.system(nx=8, device="cpu")
    a.Assemble()
    f.Assemble()
    out = cs.phase_30(torch.device("cpu"), (a, f, Vh, free),
                      time.perf_counter())
    assert out["launches"] == 0
    assert [s["launches"] for s in out["solves"]] == [0, 0]
    assert all(s["iters"] > 0 and s["rel_res"] <= cs.P30_RES
               for s in out["solves"])
    assert out["facet"]["diff"] == 0.0 and out["facet"]["ndof"] > 0
    text = capsys.readouterr().out
    for tag in ("[30 numpy rhs]", "[30 prolongation]",
                "[30 compressed facet space]", "[30 whole]"):
        assert tag in text


@pytest.mark.parametrize("numpy_mode", [False, True])
def test_parity_rewrite_modes(numpy_mode):
    """``tools/torch_parity.py``'s ``rewrite``: the JAX package's imports go
    to the port in both modes; ``--numpy`` also turns ``import jax.numpy as
    jnp`` (at any indent) into ``import numpy as jnp`` and touches nothing
    else."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_parity", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "torch_parity.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = ("import jax\n"
           "import jax.numpy as jnp\n"
           "from ngsxfem_tpu import H1\n"
           "import ngsxfem_tpu.solvers.krylov as K\n"
           "from examples import cutfem\n"
           "import examples\n"
           "def f():\n"
           "    import jax.numpy as jnp\n"
           "    return jnp.asarray(jax.numpy.ones(2))\n"
           "import jax.numpy as jnpx\n")
    got = tool.rewrite(src, numpy_mode=numpy_mode)
    jnp_line = "import numpy as jnp" if numpy_mode else "import jax.numpy as jnp"
    assert got == ("import jax\n"
                   f"{jnp_line}\n"
                   "from ngsxfem_tpu_torch import H1\n"
                   "import ngsxfem_tpu_torch.solvers.krylov as K\n"
                   "from ngsxfem_tpu_torch.examples import cutfem\n"
                   "import ngsxfem_tpu_torch.examples as examples\n"
                   "def f():\n"
                   f"    {jnp_line}\n"
                   "    return jnp.asarray(jax.numpy.ones(2))\n"
                   "import jax.numpy as jnpx\n")
    assert tool.rewrite(src) == tool.rewrite(src, numpy_mode=False)
