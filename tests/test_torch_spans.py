"""The port's spans and counters (utils/profiling.py): off unless
torch.profiler records, emitted as profiler events only inside
profiling.trace(), a bounded ring, launches counted by ops/_build.launch,
and the set-up spans. CPU only: the kernels' launches run through a stub
entry."""

from __future__ import annotations

import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import phase_vocoder_tpu_torch as pv
from phase_vocoder_tpu_torch import streaming
from phase_vocoder_tpu_torch.ops import _build
from phase_vocoder_tpu_torch.utils import profiling


@pytest.fixture
def registry(monkeypatch):
    """An empty registry for the test; the process's own comes back after."""
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=profiling.RING))
    monkeypatch.setattr(profiling, "_counters", {})


def _signal(seconds: float = 1.0, sr: int = 16000) -> torch.Tensor:
    t = torch.arange(int(seconds * sr), dtype=torch.float64) / sr
    return (0.4 * torch.sin(2 * torch.pi * 440.0 * t)).to(torch.float32)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _names(spans) -> list:
    return [s[0] for s in spans if not s[0].startswith("pv.setup.")]


def test_off_records_nothing_and_returns_the_shared_null_context(registry):
    assert profiling.span("pv.x") is profiling.span("pv.y") is profiling._NULL
    pv.time_stretch(_signal(), 2.0)
    pv.time_stretch(_signal().numpy(), 3.0, device="cpu")
    assert _names(profiling.spans()) == []
    assert profiling.counters() == {}


def test_a_time_stretch_records_its_entry_and_route_in_order_and_depth(registry):
    x = _signal()
    with _cpu_profile():
        pv.time_stretch(x, 2.0)
    got = [(s[0], s[1]) for s in profiling.spans() if not s[0].startswith("pv.setup.")]
    assert got == [("pv.time_stretch", 0), ("pv.route", 1)]
    (_, _, a, b), (_, _, c, d) = [s for s in profiling.spans() if not s[0].startswith("pv.setup.")]
    assert a <= c <= d <= b


def test_the_general_route_records_its_stages(registry):
    with _cpu_profile():
        pv.time_stretch(_signal(), 3.0)
    assert _names(profiling.spans()) == [
        "pv.time_stretch", "pv.route", "pv.stage.products", "pv.stage.overlap_add",
        "pv.stage.window_norm", "pv.stage.normalize",
    ]


def test_nested_entries_and_the_to_device_bytes(registry):
    x = _signal(0.5).numpy()
    with _cpu_profile():
        pv.pitch_shift(x, -7.0, branch_policy="faithful", device="cpu")
    spans = [s for s in profiling.spans() if not s[0].startswith("pv.setup.")]
    assert [(n, d) for n, d, _, _ in spans[:3]] == [
        ("pv.pitch_shift", 0), ("pv.to_device", 1), ("pv.route", 1)]
    inner = [s for s in spans if s[0] == "pv.stream_time_stretch"]
    assert len(inner) == 1 and inner[0][1] == 1
    segments = [s for s in spans if s[0] == "pv.segment"]
    assert segments and all(s[1] == 2 for s in segments)
    _, _, a, b = spans[1]
    assert spans[0][2] <= a <= b <= spans[2][2]  # the copy, before the route
    assert profiling.counters() == {}  # the CPU route launches nothing


def test_the_fused_stream_counts_its_segments(registry):
    x = _signal(2.0)
    with _cpu_profile():
        streaming.fused_stream_time_stretch(x, 2.0, segment_frames=64)
    spans = [(s[0], s[1]) for s in profiling.spans() if not s[0].startswith("pv.setup.")]
    assert spans[0] == ("pv.fused_stream_time_stretch", 0)
    nf = pv.pipeline.framing.num_frames(x.shape[-1], 1024, 256)
    _, s_count = streaming.fused_plan_segments(nf, 1024, 512, 64)
    assert spans[1:] == [("pv.segment", 1)] * s_count and s_count > 1


def test_a_varied_batch_records_its_grouping(registry):
    xs = [_signal(0.3), _signal(0.4), _signal(0.5)]
    with _cpu_profile():
        pv.batch_time_stretch_ragged(xs, 2.0, device="cpu")
    spans = [(s[0], s[1]) for s in profiling.spans() if not s[0].startswith("pv.setup.")]
    assert spans[:3] == [("pv.batch_time_stretch_ragged", 0), ("pv.batch_time_stretch_varied", 1),
                         ("pv.batch_group", 2)]
    assert spans.count(("pv.batch_group", 2)) == 2  # the grouping, then the one Rs group


_ENTRIES = {
    "time_stretch": lambda x: pv.time_stretch(x, 2.0),
    "pitch_shift": lambda x: pv.pitch_shift(x, -7.0),
    "stream_time_stretch": lambda x: pv.stream_time_stretch(x, 0.5),
    "fused_stream_time_stretch": lambda x: pv.fused_stream_time_stretch(x, 2.0),
    "batch_time_stretch": lambda x: pv.batch_time_stretch(torch.stack([x, x]), 2.0),
    "batch_time_stretch_ragged": lambda x: pv.batch_time_stretch_ragged([x, x[:9000]], 2.0),
    "batch_time_stretch_varied": lambda x: pv.batch_time_stretch_varied([x, x], [2.0, 3.0]),
    "chunked_time_stretch": lambda x: pv.chunked_time_stretch(x, 2.0, mesh=pv.make_mesh(), force=True),
    "batched_chunked_time_stretch": lambda x: pv.parallel.chunked.batched_chunked_time_stretch(
        torch.stack([x, x]), 2.0, mesh=pv.make_mesh_2d(1, 1)),
}


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
def test_each_entry_point_is_its_calls_outermost_span(registry, entry):
    """The readers take the outermost span of a call (depth 0, not
    set-up) as its entry point's: every public entry opens one, named
    after it, around all the others."""
    with _cpu_profile():
        _ENTRIES[entry](_signal())
    spans = [s for s in profiling.spans() if not s[0].startswith("pv.setup.")]
    outer = [s for s in spans if s[1] == 0]
    assert [s[0] for s in outer] == [f"pv.{entry}"]
    assert all(outer[0][2] <= a <= b <= outer[0][3] for _, _, a, b in spans)


def test_a_bare_profiler_sees_no_program_event(registry):
    """pvbench names an idle gap by the host op open in it; a program
    span emitted as an event would become every op's parent."""
    with _cpu_profile() as prof:
        pv.time_stretch(_signal(), 3.0)
    assert _names(profiling.spans())
    assert not [e.name for e in prof.events() if e.name.startswith("pv.")]


def test_the_trace_holds_the_spans_on_their_clock(registry, tmp_path):
    x = _signal()
    with profiling.trace(str(tmp_path)):
        pv.time_stretch(x, 2.0)
        pv.time_stretch(x, 3.0)
    data = json.loads((tmp_path / "trace.json").read_text())
    base_us = data.get("baseTimeNanoseconds", 0) / 1e3
    events = {}
    for e in data["traceEvents"]:
        if e.get("name", "").startswith("pv.") and e.get("ph") == "X":
            events.setdefault(e["name"], []).append((e["ts"] + base_us, e["ts"] + e["dur"] + base_us))
    spans = [s for s in profiling.spans() if not s[0].startswith("pv.setup.")]
    assert sorted(events) == sorted({s[0] for s in spans})
    for name, _, a, b in spans:
        start, end = events[name].pop(0)
        # The span is stamped inside its event; the slack is this machine's
        # enter and exit cost (about 1.3 ms on a first call here). Another
        # clock would miss by far more.
        assert start - 5e3 <= a / 1e3 <= b / 1e3 <= end + 5e3, name


def test_the_ring_keeps_the_newest_spans_and_reset_clears_all(registry):
    for i in range(profiling.RING + 10):
        with profiling.setup(f"t{i}"):
            pass
    spans = profiling.spans()
    assert len(spans) == profiling.RING
    assert spans[0][0] == "pv.setup.t10" and spans[-1][0] == f"pv.setup.t{profiling.RING + 9}"
    profiling.count("launches.x")
    profiling.reset()
    assert profiling.spans() == [] and profiling.counters() == {}


def test_counters_count_while_spans_record_and_launches_always(registry):
    profiling.count("launches.w", 3)
    with _cpu_profile():
        profiling.count("launches.w")
        profiling.count("launches.v", 2)
    profiling.count("launches.v")
    assert profiling.counters() == {"launches.w": 4, "launches.v": 3}


class _Lib:
    @staticmethod
    def pvoc_cuda_error_string(rc):
        return b"an error"


def test_launch_counts_by_wrapper_and_raises_on_a_failed_entry(registry, monkeypatch):
    monkeypatch.setattr(_build, "kernels", lambda: _Lib)
    calls = []

    def pvoc_stub(*args):
        calls.append(args)
        return 0

    _build.launch("fused_time_stretch", pvoc_stub, 1, 2.0, None)
    with _cpu_profile():
        _build.launch("fused_time_stretch", pvoc_stub, 3)
        _build.launch("istft_ola", pvoc_stub)
    assert calls == [(1, 2.0, None), (3,), ()]
    assert profiling.counters() == {"launches.fused_time_stretch": 2, "launches.istft_ola": 1}
    assert _names(profiling.spans()) == ["pv.launch:fused_time_stretch", "pv.launch:istft_ola"]

    def failing(*args):
        return 700

    with pytest.raises(RuntimeError, match=r"failing: CUDA error 700 \(an error\)"):
        _build.launch("fused_time_stretch", failing)
    assert profiling.counters()["launches.fused_time_stretch"] == 2


def test_the_import_span_is_recorded():
    imports = [s for s in profiling.spans() if s[0] == "pv.setup.import"]
    assert len(imports) == 1
    _, depth, a, b = imports[0]
    assert depth == 0 and 0 < b - a < 600e9


def test_a_table_build_is_a_set_up_span(registry):
    from phase_vocoder_tpu_torch.ops import fused

    fused._phasor_consts(48, 12, 37)
    fused._phasor_consts(48, 12, 37)  # a cache hit: no span
    assert [s[0] for s in profiling.spans()] == ["pv.setup.tables"]
    assert isinstance(fused._phasor_consts(48, 12, 37), np.ndarray)
