"""The port's spans and counters (``ngsxfem_tpu_torch.utils.timing``) on the
CPU: a span does nothing beyond its ``GetTimers`` total without a
profiler; under ``torch.profiler`` it records its parent, its counters and
its self time as annotations that never overlap, on the profiler's clock;
``cg::iterations`` is what the solvers return; the sync warnings become
``host_syncs``; and one weak-form step of ``examples.fictdom3d`` records
every geometry, forms and sparse span once where it calls it once.  The
card's own sync count has the ``cuda`` case."""
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ngsxfem_tpu_torch.examples import fictdom3d
from ngsxfem_tpu_torch.solvers import krylov, sparse
from ngsxfem_tpu_torch.utils import timing
from ngsxfem_tpu_torch.utils.timing import Timer, traced

CPU = [ProfilerActivity.CPU]
# the first events of a profile are slow to record: the benchmark's
# window annotation takes that cost before any program span
WARM = "bench.window"


@pytest.fixture(autouse=True)
def _empty_store():
    timing.reset_trace()
    yield
    timing.reset_trace()


def _annotations(prof):
    return sorted((e for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation() and e.name() != WARM),
                  key=lambda e: e.start_ns())


def _laplacian(n):
    A = (2 * torch.eye(n, dtype=torch.float64)
         - torch.diag(torch.ones(n - 1, dtype=torch.float64), 1)
         - torch.diag(torch.ones(n - 1, dtype=torch.float64), -1))
    return A, torch.linspace(0.5, 1.5, n, dtype=torch.float64)


def test_span_without_a_profiler_records_nothing(monkeypatch):
    """No profiler: a span adds its registry total and nothing else; no
    annotation is made and no counter moves."""
    def boom(*args, **kwargs):
        raise AssertionError("record_function called without a profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)

    @traced("probe::fn")
    def fn():
        timing.count("probe::count", 3)
        return 7

    timing.ResetTimers()
    with Timer("probe::block", block=False):
        assert fn() == 7
    A, b = _laplacian(8)
    krylov.cg(lambda v: A @ v, b, tol=1e-12)
    assert timing.spans() == [] and timing.counters() == {}
    got = timing.GetTimers()
    assert got["probe::block"][1] == got["probe::fn"][1] == got["cg"][1] == 1


def test_nested_spans_record_their_parents():
    with profile(activities=CPU):
        with Timer("a", block=False):
            with Timer("b", block=False):
                with Timer("c", block=False):
                    timing.count("n", 2)
                timing.count("n")
            with Timer("d", block=False):
                pass
        with Timer("e", block=False):
            pass
    recs = timing.spans()
    assert [(r["name"], r["parent"]) for r in recs] == [
        ("a", -1), ("b", 0), ("c", 1), ("d", 0), ("e", -1)]
    assert [r["counters"] for r in recs] == [{}, {"n": 1}, {"n": 2}, {}, {}]
    assert timing.counters() == {"n": 3}
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] >= 0:
            p = recs[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]


def _segments_run():
    """Three rounds of nested spans under a CPU profile: (annotations,
    records)."""
    timing.reset_trace()
    x = torch.ones(1000)
    with profile(activities=CPU) as prof:
        with record_function(WARM):
            for _ in range(3):
                with Timer("outer", block=False):
                    x = x.cumsum(0)
                    with Timer("inner", block=False):
                        x = x * 0.5
                        with Timer("leaf", block=False):
                            x = x + 1
                    x = x - 1
                    with Timer("inner", block=False):
                        x = x.sqrt()
    return _annotations(prof), timing.spans()


def test_annotations_are_self_time_segments_on_the_profilers_clock():
    """Each span's annotations cover its self time only: no two overlap,
    a span with k children has k + 1 of them, and on the profiler's clock
    they lie within the record's interval (read before the first opens
    and after the last closes) to 50 us, the first starting within 50 us
    of the record.  The host may be preempted between a clock read and
    an annotation: of three profiles one has to meet the times, each the
    rest."""
    offsets = []
    for _ in range(3):
        ann, recs = _segments_run()
        for u, v in zip(ann, ann[1:]):
            assert u.start_ns() + u.duration_ns() <= v.start_ns(), (
                u.name(), v.name())
        kids = [0] * len(recs)
        for r in recs:
            if r["parent"] >= 0:
                kids[r["parent"]] += 1
        for name in ("outer", "inner", "leaf"):
            assert sum(a.name() == name for a in ann) == sum(
                k + 1 for r, k in zip(recs, kids) if r["name"] == name)
        worst = 0
        for r, k in zip(recs, kids):
            mine = sorted((a for a in ann if a.name() == r["name"]
                           and r["start_ns"] <= a.start_ns()
                           <= r["end_ns"]), key=lambda a: a.start_ns())
            inside = len(mine) == k + 1 and all(
                a.start_ns() + a.duration_ns() <= r["end_ns"] + 50_000
                for a in mine)
            worst = max(worst, abs(mine[0].start_ns() - r["start_ns"])
                        if inside else float("inf"))
        offsets.append(worst)
        if worst < 50_000:
            break
    assert min(offsets) < 50_000, offsets


@pytest.mark.parametrize("solver", ["cg", "_cg_ell", "cg_ir"])
def test_cg_iterations_counter(solver):
    """``cg::iterations`` adds the k that ``cg`` returns, inside its span:
    for ``cg``, for ``_cg_ell`` on an ELL matrix and for ``cg_ir``'s inner
    solves (outer x inner)."""
    A, b = _laplacian(40)
    # the table is built before the window: to_ell counts in its own span
    rows, cols = torch.nonzero(A, as_tuple=True)
    ell = sparse.SparseMatrix(rows, cols, A[rows, cols], A.shape,
                              device="cpu").to_ell()
    free = torch.ones(40, dtype=torch.bool)
    free[0] = False
    with profile(activities=CPU):
        if solver == "cg":
            _, k, _ = krylov.cg(lambda v: A @ v, b, tol=1e-10)
        elif solver == "_cg_ell":
            _, k, _ = krylov._cg_ell(ell, b, free, 400, 1e-10)
        else:
            A32 = A.float()
            krylov.cg_ir(lambda v: A32 @ v, lambda v: A @ v, b, outer=3,
                         inner=7)
            k = 3 * 7
    assert k > 0
    assert timing.counters() == {"cg::iterations": k}
    cgs = [r for r in timing.spans() if r["name"] == "cg"]
    assert sum(r["counters"].get("cg::iterations", 0) for r in cgs) == k
    assert len(cgs) == (3 if solver == "cg_ir" else 1)


def test_sync_warnings_become_host_syncs():
    """While a span is traced the sync debug mode's warning is a count of
    the innermost span, not shown; another warning still reaches the
    caller, and the warning handler is restored at the outermost exit."""
    shown = warnings.showwarning
    with profile(activities=CPU):
        with Timer("outer", block=False):
            warnings.warn("called a synchronizing CUDA operation")
            with Timer("inner", block=False):
                for _ in range(2):
                    warnings.warn("called a synchronizing CUDA operation "
                                  "(Triggered internally at x.cpp:1.)")
                with pytest.warns(UserWarning, match="something else"):
                    warnings.warn("something else")
    assert warnings.showwarning is shown
    assert [r["counters"] for r in timing.spans()] == [
        {"host_syncs": 1}, {"host_syncs": 2}]
    assert timing.counters() == {"host_syncs": 3}


def test_forms_step_records_every_span(monkeypatch):
    """One ``fictdom3d`` step at nx=4 through the card's branches on CPU
    tensors (``Inverse()``'s Jacobi-CG, the sliced layout): every
    geometry, forms and sparse span once (``GetElementsOfType`` twice),
    each under the span that calls it, and the CG's iterations."""
    monkeypatch.setattr(sparse, "_on_card", lambda mat: True)
    with profile(activities=CPU):
        a, f, _, free, _ = fictdom3d.system(nx=4, device="cpu")
        a.Assemble()
        f.Assemble()
        inv = a.mat.Inverse(free)
        inv * f.vec
    recs = timing.spans()
    names = [r["name"] for r in recs]
    once = ["InterpolateToP1", "CutInfo::Update", "CutInfo::Update::classify",
            "CutInfo::Update::marks", "GetFacetsWithNeighborTypes",
            "GetDofsOfElements", "BilinearForm::Assemble",
            "FacetPatch::map", "LinearForm::Assemble", "InverseMatrix::InverseMatrix",
            "SparseMatrix::to_ell", "spd_free_block", "InverseMatrix::Solve",
            "cg", "prepare_ell"]
    for name in once:
        assert names.count(name) == 1, name
    assert names.count("GetElementsOfType") == 2
    assert set(names) == set(once) | {"GetElementsOfType"}
    parent = {r["name"]: (recs[r["parent"]]["name"] if r["parent"] >= 0
                          else None) for r in recs}
    assert parent["CutInfo::Update::classify"] == "CutInfo::Update"
    assert parent["CutInfo::Update::marks"] == "CutInfo::Update"
    assert parent["FacetPatch::map"] == "BilinearForm::Assemble"
    assert parent["SparseMatrix::to_ell"] == "InverseMatrix::InverseMatrix"
    assert parent["spd_free_block"] == "InverseMatrix::InverseMatrix"
    assert parent["cg"] == "InverseMatrix::Solve"
    assert parent["prepare_ell"] == "cg"
    assert inv.path == "device_cg"
    assert timing.counters()["cg::iterations"] > 0


@pytest.mark.cuda
def test_host_syncs_on_the_card():
    """On the card: a read of a device value inside a traced span is one
    ``host_syncs`` of that span, a device-only op none, and the sync debug
    mode is back as it was after the outermost span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.ones(1000, device="cuda")
    mode = torch.cuda.get_sync_debug_mode()
    with profile(activities=CPU + [ProfilerActivity.CUDA]):
        with Timer("reads", block=False):
            y = x.cumsum(0)
            float(y[-1])
            bool((y > 3).any())
            y[y > 3].sum()  # boolean-mask indexing sizes its output
            y.cpu()
        with Timer("device_only", block=False):
            (x * 2).sum()
    assert torch.cuda.get_sync_debug_mode() == mode
    assert [r["counters"] for r in timing.spans()] == [{"host_syncs": 4}, {}]
