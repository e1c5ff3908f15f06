"""Tracing and timing hooks (counterpart of
phase_vocoder_tpu/utils/profiling.py).

`trace` records a torch.profiler trace of the host and, where there is a
card, of its kernels, written as a Chrome/Perfetto trace (open it in
ui.perfetto.dev or chrome://tracing). time_calls, profile_call and
peak_gb are the measurements of the bench (bench.py) and of chip_smoke.py:
the time of each call between CUDA events, the device time of one traced
call by kernel, and the peak device memory of a call. roofline_report
holds a measured throughput to the H100 rooflines of utils/metrics.py,
and emit prints a record as one JSON line.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time

import torch

from .metrics import binding_roofline_audio_s


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


def time_calls(fn, reps: int, device="cuda", before=None) -> list[float]:
    """Milliseconds of each of `reps` calls of fn() after one warm-up:
    between CUDA events on a card, by time.perf_counter on the CPU.
    before(), if given, runs ahead of each call, outside its time (a
    barrier of several ranks)."""
    cuda = torch.device(device).type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def union_length(intervals) -> float:
    """The length of the union of (start, end) intervals: the time a
    device ran some kernel, whichever streams they ran on."""
    total, reach = 0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total, reach = total + end - start, end
        elif end > reach:
            total, reach = total + end - reach, end
    return total


def profile_call(fn, reps: int = 1) -> dict:
    """`reps` calls of fn() under torch.profiler: the device kernels of
    one call, the time some kernel ran (the union of their intervals: on
    one stream their summed time; kernels of two streams, as NCCL's beside
    the compute, overlap), the span from the first kernel's start to the
    last one's end, and the time of each kernel by name (the port's kernels launch through the
    CUDA runtime that torch loaded, so the profiler sees them beside
    torch's); with reps > 1 each is the mean over the calls, and the span
    covers them all, host gaps between the calls included. Raises if the
    trace holds no device kernel.

    The profiler drops a traced step's kernels now and then. Two steps of
    the same calls are traced and discarded first, and every step pauses
    50 ms before its calls and after they finish: on an H100, 13 of 143
    traces lost kernels without the pauses and none of 143 with them, and
    after traces of a ~39,000-kernel call 2 of 9 traces lost kernels with
    one discarded step and none of 9 with two."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=2, active=1, repeat=1)) as prof:
        for _ in range(3):
            time.sleep(0.05)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
            prof.step()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")]  # the step's own annotation
    if not kern:
        raise RuntimeError("torch.profiler recorded no device kernel")
    busy = union_length((e.time_range.start, e.time_range.end) for e in kern) / 1e3
    span = (max(e.time_range.end for e in kern) - min(e.time_range.start for e in kern)) / 1e3
    by_kernel = {}
    for e in kern:
        name = re.sub(r"\(.*", "", e.name.replace("(anonymous namespace)::", "")).replace("void ", "")
        by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return {"kernels": len(kern) / reps, "device_busy_ms": busy / reps, "device_span_ms": span,
            "idle_share": 1.0 - busy / span, "by_kernel_ms": by_kernel}


def peak_gb(fn) -> float:
    """Peak device memory (GB, all live tensors) while fn() runs."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def roofline_report(sr: int, n_fft: int, hop: int, stretch,
                    measured_audio_s_per_s: float, pitch: bool = False) -> dict:
    """A measured throughput against the binding H100 roofline
    (utils/metrics.binding_roofline_audio_s). `stretch` is one factor, or
    the (audio seconds, factor) parts of mixed work, as a batch of several
    ratios: then the bytes of every part over the memory rate and their
    operations over the FP32 rate, the larger of the two times."""
    parts = [(1.0, stretch)] if isinstance(stretch, (int, float)) else stretch
    t_bytes = t_ops = audio = 0.0
    for seconds, factor in parts:
        roof = binding_roofline_audio_s(sr, n_fft, hop, factor, pitch=pitch)
        t_bytes += seconds / roof["hbm_audio_s_per_s"]
        t_ops += seconds / roof["fft_audio_s_per_s"]
        audio += seconds
    bound = audio / max(t_bytes, t_ops)
    return {
        "roofline_audio_s_per_s": bound,
        "roofline_hbm_audio_s_per_s": audio / t_bytes,
        "roofline_fft_audio_s_per_s": audio / t_ops,
        "roofline_binding": "bytes" if t_bytes >= t_ops else "operations",
        "measured_audio_s_per_s": measured_audio_s_per_s,
        "fraction_of_roofline": measured_audio_s_per_s / bound,
    }


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)
