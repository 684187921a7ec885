"""Spans around the calls into each layer, and the reading of a profiled
sub-window.

Spans are kept in memory by the benchmark's own files; nothing inside the
program is instrumented.  In a run without tracing a span costs nothing.
In a traced run the device is synchronised at both ends of each span, so
its host-clock duration holds its device work, and inside the profiled
sub-window each span is also a profiler annotation, which places the
device's kernels and idle gaps under the span that was open.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

WINDOW = "bench.window"


class Spans:
    """``with spans("solve"): ...`` records the span's duration (seconds)
    under its name.  ``sync`` is the device's synchronise; None switches
    the spans off."""

    def __init__(self, sync=None):
        self.sync = sync
        self.annotate = False
        self.durations = defaultdict(list)

    @contextmanager
    def __call__(self, name):
        if self.sync is None:
            yield
            return
        from torch.profiler import record_function

        self.sync()
        t0 = time.perf_counter()
        with record_function(name) if self.annotate else nullcontext():
            yield
            self.sync()
        self.durations[name].append(time.perf_counter() - t0)


def profile(run, spans, cuda):
    """Run ``run()`` under ``torch.profiler`` with ``spans`` annotating, and
    return the summary of its events (``summarize``)."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    spans.annotate = True
    try:
        with torch_profile(activities=acts) as prof:
            with record_function(WINDOW):
                run()
    finally:
        spans.annotate = False
    return summarize(prof.profiler.kineto_results.events())


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(merged, s, e):
    """Length of the part of [s, e) that the merged intervals cover."""
    return sum(max(0, min(e, b) - max(s, a)) for a, b in merged
               if a < e and b > s)


def summarize(events):
    """Device operations, busy time, idle gaps by the span open during each,
    and busy time inside each span, of the events of one profiled window.

    Returns a dict (seconds): ``window_s``, ``busy_s``, ``n_ops``,
    ``ops`` {device operation: seconds}, ``idle`` {span or "outside
    spans": seconds}, ``span_busy`` {span: seconds}, ``span_n`` {span:
    count}.  With no device event ``busy_s`` is 0 and the rest empty."""
    events = list(events)
    # an annotation has a host range and, on the card, a device range over
    # its kernels: only the host range is read
    marks = {e.name() for e in events if e.is_user_annotation()} | {WINDOW}
    window = None
    spans, dev = [], []
    for e in events:
        s = e.start_ns()
        end = s + e.duration_ns()
        on_device = str(e.device_type()).endswith("CUDA")
        if e.name() in marks or e.is_user_annotation():
            if on_device:
                continue
            if e.name() == WINDOW:
                window = (s, end)
            else:
                spans.append((s, end, e.name()))
        elif on_device:
            dev.append((s, end, e.name()))
    if window is None:
        return None
    w0, w1 = window
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    ops = defaultdict(int)
    for s, e, n in dev:
        ops[n] += e - s
    merged = _merge([(s, e) for s, e, _ in dev])
    busy = sum(e - s for s, e in merged)
    spans.sort()
    starts = [s for s, _, _ in spans]
    idle = defaultdict(int)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = (spans[i][2] if i >= 0 and spans[i][1] > mid
                 else "outside spans")
        idle[label] += b - a
    span_busy, span_n = defaultdict(int), defaultdict(int)
    for s, e, n in spans:
        span_busy[n] += _overlap(merged, s, e)
        span_n[n] += 1
    ns = 1e-9
    return {"window_s": (w1 - w0) * ns, "busy_s": busy * ns,
            "n_ops": len(dev),
            "ops": {k: v * ns for k, v in ops.items()},
            "idle": {k: v * ns for k, v in idle.items()},
            "span_busy": {k: v * ns for k, v in span_busy.items()},
            "span_n": dict(span_n)}
