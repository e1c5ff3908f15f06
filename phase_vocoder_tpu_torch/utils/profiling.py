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

The port's spans and counters live here too, in one process-wide
registry. span(name) times a block of the program while torch.profiler
records (any profiler: the CLI's `--trace-dir`, pvbench's traced jobs,
profile_call); otherwise it costs one check and returns a shared null
context. setup(name) times a once-a-process set-up step (pv.setup.*)
always. A span is (name, depth, start_ns, end_ns) on time.time_ns(), the
system clock to which Kineto converts its host and device timestamps, in
a ring of the newest RING spans. Only inside trace() does a span also
enter torch.profiler.record_function, so that it lands in the exported
Chrome trace beside the kernels; under any other profiler it emits no
event, and the profiler's own ops keep their parents (pvbench names an
idle gap by the host op the gap falls in). The outermost span of a
call is its entry point's (pv.time_stretch, ...), and readers take it
so. count(name, n) adds to a counter, always: ops/_build.launch counts
each kernel launch as launches.<wrapper>. spans(), counters() and
reset() read and clear the registry.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import time

import torch

from .metrics import binding_roofline_audio_s


# ------------------------------------------------- spans and counters

RING = 65_536  # spans kept, the oldest dropped first
_spans: collections.deque = collections.deque(maxlen=RING)
_counters: dict = {}
_depth = 0  # spans open now (one thread records)
_emit = False  # inside trace(): spans also enter record_function
_recording = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


class _Span:
    """One open span; appended to the ring when it closes."""

    __slots__ = ("name", "start", "event")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _depth
        self.event = torch.autograd.profiler.record_function(self.name).__enter__() if _emit else None
        self.start = time.time_ns()
        _depth += 1
        return self

    def __exit__(self, *exc):
        global _depth
        end = time.time_ns()
        _depth -= 1
        _spans.append((self.name, _depth, self.start, end))
        if self.event is not None:
            self.event.__exit__(*exc)
        return False


def span(name: str):
    """A context that records `name` while torch.profiler records, and
    the shared null context otherwise."""
    if not _recording():
        return _NULL
    return _Span(name)


def setup(step: str):
    """A context that records the set-up span pv.setup.<step>, profiler
    or not."""
    return _Span(f"pv.setup.{step}")


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    _counters[name] = _counters.get(name, 0) + n


def spans() -> list:
    """The recorded spans, (name, depth, start_ns, end_ns), by start."""
    return sorted(_spans, key=lambda s: (s[2], s[1]))


def counters() -> dict:
    """A copy of the counters."""
    return dict(_counters)


def reset() -> None:
    """Drop every span and counter."""
    _spans.clear()
    _counters.clear()


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """Profile the enclosed block into trace_dir/trace.json, the port's
    spans among the host events.

    No-op when trace_dir is None, so call sites can pass the CLI flag
    straight through.
    """
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    global _emit
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        _emit = True
        try:
            yield
        finally:
            _emit = False
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


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
