"""The torch thread count of the port's CPU tests under pytest-xdist
(tests/torch_threads.py)."""

import os

import pytest
import torch

from tests import torch_threads


def test_an_xdist_worker_runs_its_share_of_the_cores():
    if "PYTEST_XDIST_WORKER" not in os.environ:
        pytest.skip("runs only in a pytest-xdist worker")
    share = max(1, os.cpu_count() // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
    assert torch_threads.THREADS == share
    assert torch.get_num_threads() == share


def test_outside_xdist_nothing_is_set(monkeypatch):
    monkeypatch.delenv("PYTEST_XDIST_WORKER", raising=False)
    monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
    assert torch_threads.worker_threads() is None
