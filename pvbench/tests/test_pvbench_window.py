"""The window's arithmetic on a fake job, and the trace's on a fake
profiler event list."""

import sys
import time
import types
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from pvbench import harness, trace
from pvbench.metrics import device_idle_share, host_lead_ms, kernels_per_job, roofline_share

JOB_S = 0.02


@pytest.fixture
def fake_kind(monkeypatch):
    """A job kind whose job sleeps JOB_S and returns its input."""
    mod = types.ModuleType("pvbench.jobs.fake")
    mod.make_pool = lambda cell, seed, device: [{"x": torch.full((4096,), float(i))} for i in range(3)]
    mod.entry = lambda cell: (lambda item: (time.sleep(JOB_S), item["x"].clone())[1])
    mod.audio_seconds = lambda cell, item: 10.0
    mod.work = lambda cell, item: (1.0, 2.0)
    mod.inputs = lambda cell, item: []
    mod.outputs = lambda cell, out: []
    monkeypatch.setitem(sys.modules, "pvbench.jobs.fake", mod)
    cell = harness.load_cell("hour_recording.stretch2x")
    cell["kind"] = "fake"
    return cell


def test_window_on_a_fake_job(fake_kind):
    t0 = time.time()
    rec = harness.run(fake_kind, 1, 0.3, False, torch.device("cpu"), t0)
    assert 0.3 <= rec["window_s"] <= 0.3 + 3 * JOB_S
    assert rec["jobs"] == len(rec["job_s"]) >= 10
    assert rec["audio_s"] == 10.0 * rec["jobs"]
    assert all(JOB_S <= s < 3 * JOB_S for s in rec["job_s"])
    assert 3 * JOB_S <= rec["setup_s"] < 3 * JOB_S + 5.0  # the warm jobs
    out = harness.result(fake_kind, rec, False, "cpu")
    m = out["metrics"]
    assert m["audio_s_per_s"]["value"] == pytest.approx(10.0 * rec["jobs"] / rec["window_s"])
    assert m["job_ms_p95"]["value"] == pytest.approx(np.percentile(np.array(rec["job_s"]) * 1e3, 95))
    # nothing was judged: a run that compares nothing is not correct
    assert rec["answers"] == 0 and out["correct"] is False


@dataclass
class Range:
    start: float
    end: float


@dataclass
class Event:
    name: str
    device_type: object
    time_range: Range
    cpu_parent: object = None
    is_user_annotation: bool = False


CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def fake_events():
    """Two jobs (spans 100-200 and 1000-1100 us): the first runs kernels
    k1 (110-150) and k2 (140-170) and k3 (180-190) under host
    ops aten::a (100-160) and aten::b (165-199); the second one kernel
    (1050-1060)."""
    span1 = Event(trace.SPAN, CPU, Range(100, 200), is_user_annotation=True)
    span2 = Event(trace.SPAN, CPU, Range(1000, 1100), is_user_annotation=True)
    return [
        Event("ProfilerStep#2", CPU, Range(50, 250), is_user_annotation=True),
        span1, span2,
        Event(trace.SPAN, CUDA, Range(100, 200), is_user_annotation=True),
        Event("aten::a", CPU, Range(100, 160), cpu_parent=span1),
        Event("aten::b", CPU, Range(165, 199), cpu_parent=span1),
        Event("cudaLaunchKernel", CPU, Range(101, 102), cpu_parent=Event("aten::a", CPU, Range(0, 0))),
        Event("void (anonymous namespace)::k1<3>(float*)", CUDA, Range(110, 150)),
        Event("k2", CUDA, Range(140, 170)),
        Event("void k3(float*, int)", CUDA, Range(180, 190)),
        Event("k1<3>", CUDA, Range(1050, 1060)),
    ]


def test_trace_and_readers_on_fake_events():
    jobs = trace.summarize(fake_events())
    assert [(j["start"], j["end"]) for j in jobs] == [(100, 200), (1000, 1100)]
    assert [o[0] for o in jobs[0]["ops"]] == ["k1<3>", "k2", "k3"]
    # idle: 100-110 (aten::a open), 170-180 (aten::b), 190-200 (aten::b)
    assert jobs[0]["gaps"] == [["aten::a", 10], ["aten::b", 10], ["aten::b", 10]]
    assert jobs[1]["gaps"] == [[trace.NO_OP, 50], [trace.NO_OP, 40]]
    for j in jobs:
        j["work"] = [3.35e12 * 20e-6, 0.0]  # 20 us of bytes
    rec = {"jobs": jobs}
    assert kernels_per_job.read(rec) == 2.0
    assert host_lead_ms.read(rec) == pytest.approx((10 + 50) / 2 / 1e3)
    busy = 60 + 10 + 10  # k1 and k2 merge into 110-170, k3 180-190; then 1050-1060
    assert device_idle_share.read(rec) == pytest.approx(100 * (1 - busy / 200))
    assert roofline_share.read(rec) == pytest.approx(100 * 40e-6 / (busy * 1e-6))
    bd = harness.breakdown(jobs)
    assert bd["device_ops"][0] == ["k1<3>", pytest.approx(50e-6)]
    assert bd["idle_gaps"][0] == [trace.NO_OP, pytest.approx(90e-6)]


def test_readers_find_nothing_without_device_ops():
    jobs = [{"start": 0, "end": 10, "ops": [], "gaps": [], "work": [1.0, 1.0]}]
    rec = {"jobs": jobs}
    for reader in harness.metric_readers().values():
        assert reader.read(rec) is None
