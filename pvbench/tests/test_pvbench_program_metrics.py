"""The readers of the program's own spans (pvbench/program_spans.py) on a
synthetic record and registry; and, on a card, their placement of the
entry spans against the profiler's events."""

import collections
import json

import pytest
import torch

from pvbench import harness, program_spans, trace
from pvbench.metrics import entry_host_ms, launch_host_us, program_idle_share, program_setup_s
from pvbench.tests.conftest import SEED

READERS = (entry_host_ms, launch_host_us, program_idle_share, program_setup_s)
T = 1_792_000_000_000_000_000  # the registry's clock (ns); the trace's is us from its own start


@pytest.fixture
def registry(monkeypatch):
    from phase_vocoder_tpu_torch.utils import profiling

    ring = collections.deque(maxlen=profiling.RING)
    monkeypatch.setattr(profiling, "_spans", ring)

    def put(name, depth, a_us, b_us):
        ring.append((name, depth, T + int(a_us * 1e3), T + int(b_us * 1e3)))

    return put


def jobs():
    return {"jobs": [
        {"start": 100.0, "end": 300.0, "ops": [["k", 150.0, 200.0], ["k2", 260.0, 290.0]]},
        {"start": 1000.0, "end": 1200.0, "ops": [["k", 1050.0, 1100.0]]},
    ]}


def two_jobs(put):
    put("pv.time_stretch", 0, -5e6, -4e6)  # a warm job before the traced ones
    put("pv.launch:fused_time_stretch", 1, -4.9e6, -4.8e6)
    # job 1: its entry opens 5 us after the job's span, launches at 140
    put("pv.time_stretch", 0, 105, 250)
    put("pv.route", 1, 106, 110)
    put("pv.stream_time_stretch", 1, 112, 240)  # a nested entry
    put("pv.launch:fused_time_stretch", 2, 140, 145)
    # job 2: opens 8 us after its span, launches nothing
    put("pv.time_stretch", 0, 1008, 1150)


def test_entry_and_launch_host_times(registry):
    two_jobs(registry)
    rec = jobs()
    assert entry_host_ms.read(rec) == pytest.approx(((140 - 105) + (1150 - 1008)) / 2 / 1e3)
    assert launch_host_us.read(rec) == pytest.approx(5.0)


def test_the_entries_are_placed_on_the_trace_clock(registry):
    two_jobs(registry)
    rec = jobs()
    pairs = program_spans.jobs_with_entries(rec, program_spans.registry(rec))
    assert [p[0] for p in pairs] == rec["jobs"]
    assert [len(p[2]) for p in pairs] == [1, 0]
    # off = min(105 - 100, 1008 - 1000): the earlier opening sets it
    assert program_spans.placed(pairs) == [pytest.approx((100, 245)), pytest.approx((1003, 1145))]


def test_idle_inside_the_entry_counts_and_outside_does_not(registry):
    two_jobs(registry)
    rec = jobs()
    # job 1: 100-245 less 150-200 (the 245-260 and 290-300 gaps lie outside)
    # job 2: 1003-1145 less 1050-1100; over 400 us of job spans
    assert program_idle_share.read(rec) == pytest.approx(100 * ((145 - 50) + (142 - 50)) / 400)


def test_set_up_is_the_union_without_nvcc(registry):
    registry("pv.setup.import", 0, 0, 1e6)
    registry("pv.setup.library", 0, 2e6, 5e6)
    registry("pv.setup.nvcc", 1, 2.5e6, 4.5e6)
    registry("pv.setup.tables", 0, 6e6, 6.1e6)
    registry("pv.setup.tables", 1, 6.02e6, 6.05e6)  # built inside another: once
    assert program_setup_s.read(jobs()) == pytest.approx(1.0 + 3.0 - 2.0 + 0.1)


def test_an_entry_is_a_calls_outermost_span_but_set_up(registry):
    registry("pv.setup.library", 0, 50, 60)  # a first call's library load: no entry
    registry("pv.batched_chunked_time_stretch", 0, 104, 280)
    registry("pv.launch:fused_time_stretch", 1, 130, 150)
    registry("pv.setup.tables", 0, 900, 1001)
    registry("pv.analyze", 0, 1010, 1100)  # any outermost span opens its call
    registry("pv.launch:stft_polar", 1, 1020, 1090)
    rec = jobs()
    pairs = program_spans.jobs_with_entries(rec, program_spans.registry(rec))
    assert [entry for _, entry, _ in pairs] == [(T + 104_000, T + 280_000), (T + 1_010_000, T + 1_100_000)]
    assert launch_host_us.read(rec) == pytest.approx((20 + 70) / 2)


def test_nothing_to_read_gives_none(registry, monkeypatch):
    rec = jobs()
    assert [r.read(rec) for r in READERS] == [None] * 4
    registry("pv.time_stretch", 0, 105, 250)  # fewer entries than jobs
    assert [r.read(rec) for r in READERS[:3]] == [None] * 3

    from phase_vocoder_tpu_torch.utils import profiling

    two_jobs(registry)
    monkeypatch.delattr(profiling, "spans")  # a program that keeps no registry
    assert [r.read(rec) for r in READERS] == [None] * 4


@pytest.mark.card
def test_the_entries_are_placed_on_the_card(tmp_path):
    """Twelve 2.0x jobs traced as pvbench traces them (each in the
    harness's span, 50 ms pauses outside), under profiling.trace(), so that
    each program span is also a record_function event. On the system
    clock each span lies inside its event, within the event's own enter
    and exit cost (on the H100's host 4-16 us at the start, 8-48 at the
    end, the first span to close after a pause the slowest). placed()
    puts every entry early of its event by the least delay from a job's
    span to its entry's (46-69 us there), by no more than PLACED_EARLY_US,
    and never late. Prints the numbers."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    import time

    from torch.autograd.profiler import record_function

    from phase_vocoder_tpu_torch.utils import profiling

    cell = harness.load_cell("hour_recording.stretch2x")
    k = harness.kind(cell)
    job = k.entry(cell)
    item = k.make_pool(cell, SEED, torch.device("cuda", 0))[0]
    job(item)
    torch.cuda.synchronize()
    profiling.reset()
    with profiling.trace(str(tmp_path)):
        for _ in range(12):
            time.sleep(trace.PAUSE_S)
            with record_function(trace.SPAN):
                job(item)
                torch.cuda.synchronize()
            time.sleep(trace.PAUSE_S)
    data = json.loads((tmp_path / "trace.json").read_text())
    base_us = data.get("baseTimeNanoseconds", 0) / 1e3
    events = collections.defaultdict(list)
    for e in data["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            events[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    for v in events.values():
        v.sort()
    rec = {"jobs": [{"start": a, "end": b, "ops": [["k", a, b]]} for a, b in events[trace.SPAN]]}
    spans = profiling.spans()
    pairs = program_spans.jobs_with_entries(rec, spans)
    entry = events["pv.time_stretch"]
    early = [ev[0] - at[0] for ev, at in zip(entry, program_spans.placed(pairs))]
    lead = [a / 1e3 - base_us - tj["start"] for tj, (a, _), _ in pairs]
    seen = collections.Counter()
    inside = collections.defaultdict(list)
    for name, _, a, b in spans:
        start, end = events[name][seen[name]]
        seen[name] += 1
        if a > pairs[0][1][1]:  # the first traced launch's exit is slow (CUPTI's first)
            inside[name].append((a / 1e3 - base_us - start, end - (b / 1e3 - base_us)))
    print(json.dumps({"placed_early_us": early, "job_to_entry_us": lead,
                      "inside_event_us": {n: [max(v[0] for v in x), max(v[1] for v in x),
                                              min(min(v) for v in x)] for n, x in inside.items()}}))
    assert len(pairs) == len(entry) == 12
    assert set(inside) >= {"pv.time_stretch", "pv.route", "pv.prepare", "pv.launch:fused_time_stretch"}
    for name, x in inside.items():
        assert all(-5 <= a <= 60 and -5 <= b <= 60 for a, b in x), (name, x)
    assert all(-10 <= e <= PLACED_EARLY_US for e in early), early


PLACED_EARLY_US = 100  # 46-69 us measured on the H100's host (PERF.md, section 6)
