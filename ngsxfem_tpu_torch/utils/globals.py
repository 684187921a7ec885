"""Global message-verbosity switch (NGSolve ``ngsglobals`` analog).

Counterpart of ``ngsxfem_tpu/utils/globals.py``.  The reference gates its
informational output with ``ngsglobals.msg_level`` (``IM(n)`` log levels,
e.g. xfem/cutinfo.cpp; tests set it in tests/ngsxfem_report.py:9); here the
same knob gates ``message``: ``msg_level == 0`` silences it.
"""
from __future__ import annotations


class _NgsGlobals:
    msg_level: int = 1

    def __repr__(self):
        return f"ngsglobals(msg_level={self.msg_level})"


ngsglobals = _NgsGlobals()


def message(level: int, *args):
    """Print iff ngsglobals.msg_level >= level (the IM(n) analog)."""
    if ngsglobals.msg_level >= level:
        print(*args)
