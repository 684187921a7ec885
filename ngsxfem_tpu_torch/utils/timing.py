"""Timers, the port's spans and counters, and profiling hooks.

Counterpart of ``ngsxfem_tpu/utils/timing.py`` (NGSolve's static
``Timer``/``RegionTimer`` instrumentation, which the reference leans on, e.g.
``cutint/straightcutrule.cpp:589-591``): a process-global registry of named
wall-clock timers, and ``torch_trace``, a ``torch.profiler`` trace in place
of the reference's ``jax_trace``.

One recorder.  A ``Timer`` used as a context manager (or a function wrapped
by ``traced``) is a span.  Its total and call count go to the ``GetTimers``
registry.  With ``block`` (the default for user code) it waits for the card
before reading the clock at each end (CUDA kernels run asynchronously, so an
unsynchronized host clock measures the enqueue); the program's own spans
pass ``block=False`` and never wait.

Tracing is on while a ``torch.profiler`` is active: the one switch, read
at each span's entry (a flag, well under a microsecond).  With tracing off
a span does nothing beyond its registry total, no annotation and no record:
about 1.7 us a span in all on an x86 host core.  With tracing on each span
also

- appends a record to a bounded in-memory store (``spans()``): its name,
  start and end on ``time.time_ns()`` (the profiler's clock), the index of
  its parent record, and the counters added while it was the innermost
  span;
- marks its self time as ``torch.profiler`` user annotations that never
  overlap: a span's segment closes when a child opens and reopens when the
  child closes, so an annotation covers only the span's own code and the
  device's idle gaps in it carry the innermost span's name;
- counts the host's reads of device values while a span is open:
  the outermost span turns on ``torch.cuda.set_sync_debug_mode("warn")``
  (restored at its exit) and counts each of its warnings, not shown, as
  ``host_syncs``; a waiting ``Timer`` counts its synchronises too.

``count(name, n)`` adds to the innermost open span's record and to the
process total (``counters()``), while tracing is on.  ``reset_trace()``
empties the store and the totals.

Usage::

    from ngsxfem_tpu_torch.utils.timing import Timer, PrintTimers

    with Timer("assemble"):
        a.Assemble()
    PrintTimers()

    with torch_trace("trace-dir"):     # chrome://tracing / Perfetto
        a.Assemble()
"""
from __future__ import annotations

import functools
import os
import time
import warnings
from contextlib import contextmanager

import torch

_REGISTRY: dict[str, list] = {}  # name -> [total_seconds, calls]

# whether a torch.profiler is active: the switch of the span store
_tracing = torch._C._autograd._profiler_enabled

STORE_MAX = 1 << 16  # records kept; later spans still annotate and count
SYNC_COUNTER = "host_syncs"
# the warning of torch.cuda.set_sync_debug_mode("warn") at each sync
_SYNC_WARNING = "called a synchronizing CUDA operation"

_records: list[list] = []  # [name, start_ns, end_ns, parent, {counter: n}]
_totals: dict[str, int] = {}
_open: list["_Segment"] = []  # the traced spans now open, innermost last
_watch = None  # (catch_warnings, previous showwarning, previous sync mode)


class _Segment:
    """An open traced span: its record's index (-1 once the store is full)
    and the annotation of its current self-time segment."""

    __slots__ = ("name", "index", "annotation")

    def __init__(self, name, index):
        self.name = name
        self.index = index
        self.annotation = None

    def annotate(self):
        from torch.autograd.profiler import record_function

        self.annotation = record_function(self.name)
        self.annotation.__enter__()

    def close(self):
        self.annotation.__exit__(None, None, None)
        self.annotation = None


def count(name: str, n=1):
    """Add ``n`` to counter ``name`` in the innermost open span's record and
    in the process total, while tracing is on."""
    if not _tracing():
        return
    _totals[name] = _totals.get(name, 0) + n
    if _open and _open[-1].index >= 0:
        c = _records[_open[-1].index][4]
        c[name] = c.get(name, 0) + n


def _show(message, category, filename, lineno, file=None, line=None):
    """``warnings.showwarning`` while spans are traced: a sync warning is a
    count, anything else goes on to the previous handler."""
    if str(message).startswith(_SYNC_WARNING):
        count(SYNC_COUNTER)
    else:
        _watch[1](message, category, filename, lineno, file, line)


def _watch_syncs():
    global _watch
    cw = warnings.catch_warnings()
    cw.__enter__()
    warnings.filterwarnings("always", message=_SYNC_WARNING)
    # said once a process when the mode is first set
    warnings.filterwarnings("ignore", message="Synchronization debug mode")
    mode = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    _watch = (cw, warnings.showwarning, mode)
    warnings.showwarning = _show


def _unwatch_syncs():
    global _watch
    cw, _, mode = _watch
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)
    _watch = None
    cw.__exit__(None, None, None)


def _enter(name):
    """Open a traced span: close the parent's segment, start the record and
    the span's first segment."""
    if _open:
        _open[-1].close()
    else:
        _watch_syncs()
    parent = _open[-1].index if _open else -1
    index = len(_records) if len(_records) < STORE_MAX else -1
    if index >= 0:
        _records.append([name, time.time_ns(), None, parent, {}])
    seg = _Segment(name, index)
    seg.annotate()
    _open.append(seg)
    return seg


def _exit(seg):
    """Close a traced span: its last segment and record, then reopen the
    parent's segment."""
    seg.close()
    if seg.index >= 0:
        _records[seg.index][2] = time.time_ns()
    _open.pop()  # spans are with-blocks: ``seg`` is the innermost
    if _open:
        _open[-1].annotate()
    else:
        _unwatch_syncs()


def spans():
    """The store: one dict per traced span, in the order they opened, with
    ``name``, ``start_ns`` and ``end_ns`` (``time.time_ns()``; ``end_ns``
    None while open), ``parent`` (index in this list, -1 at top level) and
    ``counters`` ({name: n} added while it was the innermost span)."""
    return [{"name": r[0], "start_ns": r[1], "end_ns": r[2], "parent": r[3],
             "counters": dict(r[4])} for r in _records]


def counters():
    """{name: n}: the process totals of ``count`` since ``reset_trace``."""
    return dict(_totals)


def reset_trace():
    """Empty the span store and the counter totals."""
    _records.clear()
    _totals.clear()


def _sync(result=None):
    """Wait for the card: the device of ``result`` (a tensor), or every
    initialized CUDA device.  Nothing to wait for on the CPU."""
    if torch.is_tensor(result):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
            count(SYNC_COUNTER)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        count(SYNC_COUNTER)


class Timer:
    """Named accumulating wall-clock timer (NGSolve Timer analog) and, as a
    context manager, a span (module docstring).  With ``block`` (the
    default) it waits for the card before reading the clock at the start
    and the end of a region."""

    def __init__(self, name: str, block=True):
        self.name = name
        self.block = block
        self._t0 = None
        self._seg = None

    def Start(self):
        if self.block:
            _sync()
        self._t0 = time.perf_counter()
        return self

    def Stop(self, result=None):
        if self.block:
            _sync(result)
        dt = time.perf_counter() - self._t0
        ent = _REGISTRY.setdefault(self.name, [0.0, 0])
        ent[0] += dt
        ent[1] += 1
        return dt

    def __enter__(self):
        if _tracing():
            self._seg = _enter(self.name)
        return self.Start()

    def __exit__(self, *exc):
        self.Stop()
        if self._seg is not None:
            _exit(self._seg)
            self._seg = None
        return False


def traced(name: str):
    """Decorator: each call of the function is a program span ``name``
    (``Timer(name, block=False)``)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with Timer(name, block=False):
                return fn(*args, **kwargs)
        return run
    return wrap


def GetTimers():
    """{name: (total_seconds, calls)} snapshot of all timers."""
    return {k: tuple(v) for k, v in _REGISTRY.items()}


def ResetTimers():
    _REGISTRY.clear()


def PrintTimers():
    """NGSolve-timer-report-style table."""
    if not _REGISTRY:
        print("no timers recorded")
        return
    w = max(len(k) for k in _REGISTRY)
    print(f"{'timer':<{w}} {'calls':>7} {'total[s]':>10} {'per-call[ms]':>13}")
    for k, (tot, n) in sorted(_REGISTRY.items(), key=lambda kv: -kv[1][0]):
        print(f"{k:<{w}} {n:>7} {tot:>10.4f} {1e3 * tot / max(n, 1):>13.3f}")


@contextmanager
def torch_trace(logdir: str):
    """``torch.profiler`` trace of the region (host and, with a card, device
    activity), written to ``logdir/trace.json`` (Chrome trace format);
    yields the profiler, whose ``key_averages()`` sums kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextmanager
def region(name: str):
    """RegionTimer analog: ``with region("assemble"): ...``."""
    with Timer(name):
        yield
