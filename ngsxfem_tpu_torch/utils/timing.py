"""Timers and profiling hooks.

Counterpart of ``ngsxfem_tpu/utils/timing.py`` (NGSolve's static
``Timer``/``RegionTimer`` instrumentation, which the reference leans on, e.g.
``cutint/straightcutrule.cpp:589-591``): a process-global registry of named
wall-clock timers whose context manager waits for the card (CUDA
kernels run asynchronously, so an unsynchronized host clock measures the
enqueue), and ``torch_trace``, a ``torch.profiler`` trace in place of the
reference's ``jax_trace``.

Usage::

    from ngsxfem_tpu_torch.utils.timing import Timer, PrintTimers

    with Timer("assemble"):
        a.Assemble()
    PrintTimers()

    with torch_trace("trace-dir"):     # chrome://tracing / Perfetto
        a.Assemble()
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch

_REGISTRY: dict[str, list] = {}  # name -> [total_seconds, calls]


def _sync(result=None):
    """Wait for the card: the device of ``result`` (a tensor), or every
    initialized CUDA device.  Nothing to wait for on the CPU."""
    if torch.is_tensor(result):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Named accumulating wall-clock timer (NGSolve Timer analog).  With
    ``block`` (the default) it waits for the card before reading the clock
    at the end of a region."""

    def __init__(self, name: str, block=True):
        self.name = name
        self.block = block
        self._t0 = None

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
        return self.Start()

    def __exit__(self, *exc):
        self.Stop()
        return False


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
