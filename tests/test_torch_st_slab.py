"""One space-time CutFEM slab of the PyTorch port on a moving sphere (the
benchmark's ``movingdomain3d-st-p1.slabs``), on the CPU at nx = 6 and 8,
against the benchmark's plain reference ``benchmark/reference/stcut.py``:

- at three positions of the sphere (a slab at rest, with no vertex root in
  time, and two moving slabs, each with vertex roots inside the slab) the
  program's marks equal the reference's, and its ``a.mat`` applied to a
  seeded vector, its ``f.vec`` and its solution agree with the reference's
  within the cell's limits;
- a chain of three slabs carries each slab's top to the next slab's bottom
  and agrees slab by slab;
- under ``torch.profiler`` the spans ``SpaceTimeCutRule``,
  ``InverseMatrix::host_lu``, ``SpaceTimeInterpolateToP1``,
  ``RestrictGFInTime`` and ``CutInfo::Update::marks`` are recorded, the
  counter ``SpaceTimeCutRule::elements`` counts the cut elements of the
  three rules a slab builds, and ``InverseMatrix::host_lu::rows`` the
  free rows;
- the default ``Inverse()``'s dense LU on the card (path ``"device_lu"``),
  taken on CPU tensors with ``sparse._on_card`` and
  ``sparse._dense_lu_budget`` patched: its solution against the host LU's
  on the slab at nx=6 and on ``stokescutfem`` at nx=4, the budget rule,
  the explicit direct names, a singular block on both paths, its span and
  counter; and, on a card only (marker ``cuda``), the slab at nx=8.
"""
import contextlib
import os
import sys
import warnings
from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import registry  # noqa: E402
from harness.trace import Spans  # noqa: E402
from harness.traffic import Generator, Step  # noqa: E402

CPU = torch.device("cpu")
CONFIG = "movingdomain3d-st-p1"
CELL = "movingdomain3d-st-p1.slabs"
NO_LOAD = (0.0, (0.0, 0.0, 0.0))
# (bottom, top) centres of a slab: at rest, a chord of the walk, a longer
# diagonal move
SLABS = [((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
         ((0.0, 0.0, 0.0), (0.0342, 0.0482, 0.0587)),
         ((-0.11, 0.07, 0.02), (-0.05, 0.03, 0.09))]


def _driver(nx):
    bench = registry.load_benchmark()
    sizes = {**registry.sizes(bench, CONFIG), "nx": nx}
    traffic = registry.traffic(CELL)
    return registry.driver(CONFIG), sizes, traffic


def _roots(nx, bottom, top, radius):
    """Vertices whose level set changes sign inside the slab."""
    from reference import cutp1

    lat = cutp1.Lattice(nx, -1.0, 1.0, CPU)
    phi = [torch.linalg.vector_norm(lat.X - torch.tensor(c,
                                                         dtype=torch.float64),
                                    dim=1) - radius for c in (bottom, top)]
    return int(((phi[0] < 0) != (phi[1] < 0)).sum())


@pytest.mark.parametrize("nx", [6, 8])
@pytest.mark.parametrize("slab", range(len(SLABS)))
def test_slab_matches_reference(nx, slab):
    drv, sizes, traffic = _driver(nx)
    bottom, top = SLABS[slab]
    roots = _roots(nx, bottom, top, sizes["radius"])
    assert (roots == 0) if slab == 0 else (roots > 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        st = drv.setup(sizes, traffic, CPU)
        st.prev = bottom
        out = drv.step(st, Step(1, top, NO_LOAD), Spans(None))
        assert int(out["geom"]["hasif"].np.sum()) > 0
        r, = drv.compare(sizes, traffic, [(Step(1, top, NO_LOAD), out)],
                         drv.release(st), CPU, 2 ** 31 + 11 * slab + nx)
    lim = traffic["limits"]
    assert r["geom"] == 0 and r["active"] == 0, r
    for k in ("op", "load", "sol"):
        assert r[k] <= lim[k], (k, r)


@pytest.mark.parametrize("nx", [6, 8])
def test_slab_chain_carries_the_top(nx):
    drv, sizes, traffic = _driver(nx)
    gen = Generator(traffic, sizes, 2 ** 32 + 3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        st = drv.setup(sizes, traffic, CPU)
        ndof = st.Vh.ndof
        outs = []
        for _ in range(3):
            inp = next(gen)
            out = drv.step(st, inp, Spans(None))
            # the program's bottom values of the next slab: its solution's
            # top, through RestrictGFInTime
            assert torch.equal(st.uold.vec.data, out["sol"][ndof:])
            outs.append((inp, out))
        for (ia, a), (_, b) in zip(outs, outs[1:]):
            assert torch.equal(b["uold"], a["sol"][ndof:])
            assert b["bottom"] == tuple(ia.centre)
        readings = drv.compare(sizes, traffic, outs, drv.release(st), CPU,
                               2 ** 31 + 7)
    lim = traffic["limits"]
    for r in readings:
        assert r["geom"] == 0 and r["active"] == 0, r
        for k in ("op", "load", "sol"):
            assert r[k] <= lim[k], (k, r)


def test_spans_and_counters_of_a_slab():
    from ngsxfem_tpu_torch.utils import timing

    drv, sizes, traffic = _driver(6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        st = drv.setup(sizes, traffic, CPU)
        st.prev = SLABS[1][0]
        timing.reset_trace()
        with profile(activities=[ProfilerActivity.CPU]):
            out = drv.step(st, Step(1, SLABS[1][1], NO_LOAD), Spans(None))
    recs = timing.spans()
    tot = timing.counters()
    timing.reset_trace()
    names = [r["name"] for r in recs]
    for name in ("SpaceTimeInterpolateToP1", "RestrictGFInTime",
                 "CutInfo::Update::classify", "CutInfo::Update::marks",
                 "SpaceTimeCutRule", "InverseMatrix::host_lu"):
        assert name in names, (name, sorted(set(names)))
    # the cut rule of CutInfo and of the two space-time volume integrals
    assert names.count("SpaceTimeCutRule") == 3
    ncut = int(out["geom"]["hasif"].np.sum())
    assert tot["SpaceTimeCutRule::elements"] == 3 * ncut > 0
    assert tot["InverseMatrix::host_lu::rows"] == int(
        out["geom"]["free"].np.sum())
    # the counters sit on the spans that count them
    for r in recs:
        for c in r["counters"]:
            if c.startswith("SpaceTimeCutRule"):
                assert r["name"] == "SpaceTimeCutRule"
            if c.startswith("InverseMatrix::host_lu"):
                assert r["name"] == "InverseMatrix::host_lu"
    # both restrictions of a slab: the level set's bottom, the solution's top
    assert names.count("RestrictGFInTime") == 2
    assert tot.get("host_syncs", 0) == 0


def test_host_lu_of_a_float32_matrix():
    """The host LU factorizes a float32 matrix in float64 (the right-hand
    side's dtype there) and returns the default dtype."""
    from ngsxfem_tpu_torch.solvers.sparse import SparseMatrix

    g = torch.Generator().manual_seed(2 ** 31 + 1)
    n = 12
    A = torch.rand(n, n, generator=g, dtype=torch.float64) + n * torch.eye(
        n, dtype=torch.float64)
    r, c = torch.nonzero(A != 0, as_tuple=True)
    b = torch.rand(n, generator=g, dtype=torch.float64)
    free = torch.arange(n) % 3 != 0
    x = {}
    for dt in (torch.float32, torch.float64):
        M = SparseMatrix(r, c, A[r, c].to(dt), (n, n), device="cpu")
        x[dt] = M.Inverse(free.numpy()).solve(b)
        assert x[dt].dtype == torch.float64
        assert torch.all(x[dt][~free] == 0)
    Af = A[free][:, free]
    want = torch.linalg.solve(Af, b[free])
    assert torch.allclose(x[torch.float64][free], want, rtol=1e-13,
                          atol=0)
    assert torch.allclose(x[torch.float32][free], want, rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def slab6():
    """The slab at nx=6 of ``SLABS[1]``: (matrix, right-hand side, free
    dofs), on the CPU."""
    drv, sizes, traffic = _driver(6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        st = drv.setup(sizes, traffic, CPU)
        st.prev = SLABS[1][0]
        out = drv.step(st, Step(1, SLABS[1][1], NO_LOAD), Spans(None))
    return out["mat"], out["rhs"], out["geom"]["free"]


def _stokes4():
    """``stokescutfem`` at nx=4: (matrix, right-hand side, free dofs, the
    pressure's first dof)."""
    from ngsxfem_tpu_torch.examples import stokescutfem

    a, f, X, free = stokescutfem.system(nx=4, device="cpu")[:4]
    a.Assemble()
    f.Assemble()
    return a.mat, f.vec.data, free, X.components[0].ndof


@contextlib.contextmanager
def _card_policy(budget=None):
    """The card's policy on CPU tensors (``sparse._on_card`` patched), with
    a dense LU budget of ``budget`` bytes (the CPU's, 0, for None)."""
    from ngsxfem_tpu_torch.solvers import sparse

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(sparse, "_on_card",
                                              lambda t: True))
        if budget is not None:
            stack.enter_context(mock.patch.object(
                sparse, "_dense_lu_budget", lambda device: budget))
        yield


def _rel(x, y):
    return float(torch.linalg.vector_norm(x - y)
                 / torch.linalg.vector_norm(y))


def _without_free_mean(x, free, first):
    """``x`` less the mean of its free entries from ``first`` on."""
    fr = torch.as_tensor(free)
    fr[:first] = False
    return x - torch.where(fr, x[fr].mean(), 0.0)


@pytest.mark.parametrize("name", ["st", "stokes"])
def test_default_inverse_dense_lu(name, slab6):
    """On the card's policy, a non-symmetric free block within the budget
    takes the dense LU: residual 1e-12 of the right-hand side on the free
    rows, the host LU's solution to 1e-12, zero off the free rows, the
    default dtype.  Stokes' free block (condition ~1e11 at nx=4) nearly
    leaves the pressure's constant free, and along it the two LUs differ
    by ~5e-7: they are compared with the free pressure's mean taken out."""
    A, b, free, first = (*slab6, None) if name == "st" else _stokes4()
    x_lu = A.Inverse(free, inverse="umfpack") * b
    with _card_policy(1 << 50):
        inv = A.Inverse(free)
        assert inv.path == "device_lu"
        x = inv * b
    fr = torch.as_tensor(inv.free)
    assert x.dtype == torch.float64 and torch.all(x[~fr] == 0)
    assert _rel((A * x)[fr], b[fr]) <= 1e-12
    if first is not None:
        x, x_lu = (_without_free_mean(v, fr, first) for v in (x, x_lu))
    assert _rel(x, x_lu) <= 1e-12


# budget as a function of the dense LU's bytes, ``sparse._dense_lu_bytes``
@pytest.mark.parametrize("methods,budget,path", [
    (("",), None, "host_lu"),             # the CPU's budget, 0
    (("",), lambda need: need - 1, "host_lu"),
    (("",), lambda need: need, "device_lu"),
    (("umfpack", "sparsecholesky", "pardiso", "masterinverse"),
     lambda need: 2 * need, "host_lu"),
])
def test_default_inverse_dense_lu_rule(methods, budget, path, slab6):
    from ngsxfem_tpu_torch.solvers import sparse

    A, _, free = slab6
    assert sparse._dense_lu_budget(A.vals.device) == 0
    need = sparse._dense_lu_bytes(int(free.np.sum()), A.ell())
    for method in methods:
        assert A.Inverse(free, inverse=method).path == "host_lu"
        with _card_policy(None if budget is None else budget(need)):
            assert A.Inverse(free, inverse=method).path == path


@pytest.mark.parametrize("budget,path", [(1 << 50, "device_lu"),
                                         (0, "host_lu")])
def test_default_inverse_singular_block_raises(budget, path):
    """A non-symmetric free block with a zero row: both LUs raise."""
    from ngsxfem_tpu_torch.solvers.sparse import SparseMatrix

    n = 6
    A = torch.diag(torch.arange(1.0, n + 1, dtype=torch.float64))
    A[0, 1] = 0.5
    A[3] = 0.0  # a free row of zeros
    r, c = torch.nonzero(A != 0, as_tuple=True)
    M = SparseMatrix(r, c, A[r, c], (n, n), device="cpu")
    with _card_policy(budget):
        inv = M.Inverse()
        assert inv.path == path
        with pytest.raises(RuntimeError, match="singular"):
            inv * torch.ones(n, dtype=torch.float64)


def test_dense_lu_span_and_counter(slab6):
    """``InverseMatrix::device_lu`` once a solve inside
    ``InverseMatrix::Solve``; its counter ``::rows`` once a factorization,
    the free rows; no host LU."""
    from ngsxfem_tpu_torch.utils import timing

    A, b, free = slab6
    timing.reset_trace()
    with _card_policy(1 << 50), profile(activities=[ProfilerActivity.CPU]):
        inv = A.Inverse(free)
        inv * b
        inv * b
    recs = timing.spans()
    tot = timing.counters()
    timing.reset_trace()
    names = [r["name"] for r in recs]
    assert names.count("InverseMatrix::device_lu") == 2
    assert "InverseMatrix::host_lu" not in names
    for r in recs:
        if r["name"] == "InverseMatrix::device_lu":
            assert recs[r["parent"]]["name"] == "InverseMatrix::Solve"
    counted = [r for r in recs if "InverseMatrix::device_lu::rows"
               in r["counters"]]
    assert len(counted) == 1
    assert counted[0]["name"] == "InverseMatrix::device_lu"
    assert tot["InverseMatrix::device_lu::rows"] == int(free.np.sum())
    assert "InverseMatrix::host_lu::rows" not in tot


@pytest.mark.cuda
def test_dense_lu_on_the_card():
    """The slab at nx=8 on the card: the default ``Inverse()`` takes the
    dense LU and matches the host LU to 1e-12; with a budget of 0 it takes
    the host LU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ngsxfem_tpu_torch.solvers import sparse

    dev = torch.device("cuda")
    drv, sizes, traffic = _driver(8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        st = drv.setup(sizes, traffic, dev)
        st.prev = SLABS[1][0]
        out = drv.step(st, Step(1, SLABS[1][1], NO_LOAD), Spans(None))
    A, b, free = out["mat"], out["rhs"], out["geom"]["free"]
    inv = A.Inverse(free)
    assert inv.path == "device_lu"
    x = inv * b
    assert x.device.type == "cuda"
    x_lu = A.Inverse(free, inverse="umfpack") * b
    assert _rel(x, x_lu) <= 1e-12, _rel(x, x_lu)
    with mock.patch.object(sparse, "_dense_lu_budget", lambda device: 0):
        assert A.Inverse(free).path == "host_lu"
