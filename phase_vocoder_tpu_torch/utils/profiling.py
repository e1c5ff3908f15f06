"""Tracing and timing hooks (counterpart of
phase_vocoder_tpu/utils/profiling.py).

`trace` records a torch.profiler trace of the host and, where there is a
card, of its kernels, written as a Chrome/Perfetto trace (open it in
ui.perfetto.dev or chrome://tracing). The JAX package's roofline_report
reads TPU roofline numbers; its H100 counterpart waits for the bench.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """Profile the enclosed block into trace_dir/trace.json.

    No-op when trace_dir is None, so call sites can pass the CLI flag
    straight through.
    """
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


@contextlib.contextmanager
def stage_timer(results: dict, name: str):
    """Wall-clock a stage into `results[name]` (seconds), waiting for the
    card's queued work first when there is a card."""
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    results[name] = time.perf_counter() - t0
