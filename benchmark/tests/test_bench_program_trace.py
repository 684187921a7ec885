"""The per-layer metrics that read the program's own spans and counters
(``ngsxfem_tpu_torch.utils.timing``), on synthetic stores, and the idle
gaps of a profiled window labelled by the innermost program span."""
import pytest

from conftest import copy_benchmark, run_on_cpu
from harness import registry
from harness.trace import WINDOW, summarize

SPAN_METRICS = {"to_ell_ms": "SparseMatrix::to_ell",
                "spd_check_ms": "spd_free_block",
                "cutinfo_marks_ms": "CutInfo::Update::marks"}
COUNT_METRICS = {"cg_iters_per_step": "cg::iterations",
                 "host_syncs_per_step": "host_syncs"}
NEW = list(SPAN_METRICS) + list(COUNT_METRICS)


def _rec(name, t0_ms, t1_ms, parent=-1, **counters):
    """A store record; ``t1_ms`` None: still open."""
    return {"name": name, "start_ns": int(t0_ms * 1e6),
            "end_ns": None if t1_ms is None else int(t1_ms * 1e6),
            "parent": parent,
            "counters": {k.replace("__", "::"): v
                         for k, v in counters.items()}}


@pytest.fixture
def store(monkeypatch):
    """Replaces the program's store by the list it returns."""
    from ngsxfem_tpu_torch.utils import timing

    recs = []
    monkeypatch.setattr(timing, "spans", lambda: [dict(r) for r in recs])
    return recs


def _read(name):
    return registry.metric(name).read(None)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_metric_is_the_mean_per_call(store, metric):
    span = SPAN_METRICS[metric]
    store += [_rec("InverseMatrix::InverseMatrix", 0, 100),
              _rec(span, 10, 13.5, parent=0), _rec("other", 20, 90),
              _rec(span, 200, 206.5), _rec(span, 300, 300.25),
              _rec(span, 400, None)]  # still open: left out
    assert _read(metric) == pytest.approx((3.5 + 6.5 + 0.25) / 3)


def _step(base, solve, iters, syncs):
    """The records of one forms step: the solve (once a step) with its CG,
    and the inverse's to_ell, with counters where they were added."""
    i = len(base)
    return base + [
        _rec("InverseMatrix::InverseMatrix", 0, 1, host_syncs=2),
        _rec("SparseMatrix::to_ell", 0, 1, parent=i, host_syncs=3),
        _rec(solve, 1, 2, host_syncs=1),
        _rec("cg", 1, 2, parent=i + 2, cg__iterations=iters,
             host_syncs=syncs)]


@pytest.mark.parametrize("metric", sorted(COUNT_METRICS))
@pytest.mark.parametrize("tries", [1, 3])
def test_counter_per_step_does_not_depend_on_the_tries(store, metric,
                                                       tries):
    """Five profiled steps a try, taken once or three times: the counter
    summed over every span, over the calls of the once-a-step span."""
    recs = []
    for _ in range(tries):
        for k in (100, 110, 120, 130, 140):
            recs = _step(recs, "InverseMatrix::Solve", k, k + 1)
    store += recs
    want = {"cg_iters_per_step": 120.0,
            "host_syncs_per_step": 2 + 3 + 1 + 121.0}[metric]
    assert _read(metric) == pytest.approx(want)


def test_lattice_step_is_one_cg_ir(store):
    """Without an ``Inverse`` solve the step is the refinement's
    ``cg_ir``: its 4 inner solves and a float64 fallback outside it."""
    for fallback in (0, 60):
        store.append(_rec("cg_ir", 0, 1))
        i = len(store) - 1
        for _ in range(4):
            store.append(_rec("cg", 0, 1, parent=i, cg__iterations=120))
        if fallback:
            store.append(_rec("cg", 1, 2, cg__iterations=fallback,
                              host_syncs=fallback))
    assert _read("cg_iters_per_step") == pytest.approx(480 + 30)
    assert _read("host_syncs_per_step") == pytest.approx(30)


@pytest.mark.parametrize("metric", NEW)
def test_empty_store_reads_none(store, metric):
    assert _read(metric) is None


@pytest.mark.parametrize("metric", NEW)
def test_a_program_without_the_store_reads_none(monkeypatch, metric):
    """The parent commit's program has no ``spans``: no value, no raise."""
    from ngsxfem_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "spans")
    assert _read(metric) is None


class _Ev:
    """A kineto event as ``summarize`` reads it (times in ns)."""

    def __init__(self, name, start, end, user=False, device="CPU"):
        self._n, self._s, self._d = name, start, end - start
        self._u, self._dev = user, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return self._u

    def device_type(self):
        return f"DeviceType.{self._dev}"


def _ann(name, s, e):
    return _Ev(name, s, e, user=True)


def _kernel(s, e):
    return _Ev("kernel", s, e, device="CUDA")


def test_idle_gaps_carry_the_innermost_program_span():
    """The benchmark's ``solve`` block holds the program's ``Solve`` span,
    which holds ``cg``: as self-time segments (``Solve`` closed while ``cg``
    runs, reopened after) every gap inside program code takes the
    innermost span's name; a gap between program spans stays the
    benchmark's, one after the last span is "outside spans"."""
    events = [_ann(WINDOW, 0, 1000), _ann("solve", 100, 990),
              _ann("InverseMatrix::Solve", 140, 200),
              _ann("cg", 200, 800),
              _ann("InverseMatrix::Solve", 800, 890),
              # the annotations' device ranges are not read
              _Ev("cg", 300, 700, user=True, device="CUDA"),
              _kernel(0, 100), _kernel(150, 160), _kernel(300, 310),
              _kernel(700, 710), _kernel(815, 820), _kernel(850, 860),
              _kernel(960, 1000)]
    s = summarize(events)
    ns = 1e-9
    assert s["idle"] == pytest.approx({
        "solve": 50 * ns,                  # 100-150, before the program
        # 160-300, 310-700 and 710-815, whose midpoint lies in cg
        "cg": (140 + 390 + 105) * ns,
        "InverseMatrix::Solve": 30 * ns,   # 820-850, Solve reopened
        "outside spans": 100 * ns})        # 860-960, after 890
    assert s["span_busy"]["cg"] == pytest.approx(20 * ns)
    assert s["span_busy"]["InverseMatrix::Solve"] == pytest.approx(
        (10 + 5 + 10) * ns)
    assert s["n_ops"] == 7


def test_real_segments_label_the_gaps_inside_them():
    """The program's own annotations from a CPU profile, nested in a
    benchmark block, with device work placed everywhere but inside one
    segment: the gap is labelled by that segment's span, the child's and
    the parent's reopened one alike."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from ngsxfem_tpu_torch.utils import timing
    from ngsxfem_tpu_torch.utils.timing import Timer

    timing.reset_trace()
    x = torch.ones(1000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            with record_function("solve"):
                with Timer("InverseMatrix::Solve", block=False):
                    x = x.cumsum(0)
                    with Timer("cg", block=False):
                        x = x.cumsum(0)
                    x = x.cumsum(0)
    timing.reset_trace()
    events = list(prof.profiler.kineto_results.events())
    segs = sorted((e for e in events if e.is_user_annotation()
                   and e.name() in ("InverseMatrix::Solve", "cg")),
                  key=lambda e: e.start_ns())
    assert [e.name() for e in segs] == ["InverseMatrix::Solve", "cg",
                                        "InverseMatrix::Solve"]
    win = next(e for e in events if e.name() == WINDOW)
    w0, w1 = win.start_ns(), win.start_ns() + win.duration_ns()
    for seg in segs:
        a, b = seg.start_ns(), seg.start_ns() + seg.duration_ns()
        assert b - a > 100
        s = summarize(events + [_kernel(w0, a + 1), _kernel(b - 1, w1)])
        assert s["idle"] == pytest.approx({seg.name(): (b - a - 2) * 1e-9})


def test_a_traced_run_reports_the_program_metrics(tmp_path, monkeypatch):
    """A traced run of ``fictdom3d-p1-forms.moving`` at nx=4 on the CPU,
    through the card's ``Inverse()`` branch, reports the five metrics from
    the program's store (no sync on the CPU: ``host_syncs_per_step`` 0)."""
    from ngsxfem_tpu_torch.solvers import sparse
    from ngsxfem_tpu_torch.utils import timing

    monkeypatch.setattr(sparse, "_on_card", lambda mat: True)
    timing.reset_trace()
    bench_dir = copy_benchmark(tmp_path, 4)
    res, detail = run_on_cpu(bench_dir, "fictdom3d-p1-forms.moving",
                             trace=True)
    timing.reset_trace()
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(NEW) <= set(m)
    assert m["host_syncs_per_step"] == 0
    assert m["cg_iters_per_step"] > 0
    assert 0 < m["to_ell_ms"] and 0 < m["spd_check_ms"]
    assert 0 < m["cutinfo_marks_ms"] < m["cut_ms"]
