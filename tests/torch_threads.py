"""One torch thread count per pytest-xdist worker for the port's CPU tests.

torch starts as many intra-op threads as the machine has cores in every
process. Under `pytest -n W` each of the W workers would do so, and
W x cores threads would share the cores: the port's tests, which are
mostly torch on the CPU, then take tens of times their serial time. So
each xdist worker sets torch's intra-op threads to its share of the
cores, max(1, os.cpu_count() // W), and the same count as OMP_NUM_THREADS
for the processes that its tests start. Outside xdist nothing changes.

The setting is made when this module is imported. It lives here, and not
in tests/conftest.py, because that file is the JAX suite's;
tests/test_torch_threads.py imports it, and every xdist worker collects
the whole of tests/ (and so imports it) before it runs its first test.
Tests that set thread counts on purpose (test_torch_plain_rounding.py,
the gloo workers of torch_dist.py) still set their own.
"""

from __future__ import annotations

import os

import torch


def worker_threads() -> int | None:
    """Torch threads for this process: its share of the cores under
    pytest-xdist (PYTEST_XDIST_WORKER_COUNT workers), None outside it."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if "PYTEST_XDIST_WORKER" not in os.environ or not workers:
        return None
    return max(1, (os.cpu_count() or 1) // int(workers))


THREADS = worker_threads()
if THREADS is not None:
    torch.set_num_threads(THREADS)
    os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
