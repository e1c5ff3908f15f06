"""Multichannel recordings on time_stretch's and pitch_shift's normal path
(pipeline.py): a (C, T) signal, channels first, gives (C, T_out), and row
c is bit for bit the 1-D call on x[c]. On the fused route the channels
are the batch axis of one fused_time_stretch_batch launch; every other
route runs the 1-D route channel by channel and stacks the rows.

On the CPU (the plain versions):
  * (C, T) against the per-channel 1-D calls at 2.0x, 3.0x and 0.5x for
    C = 1, 2 and 8, on the faithful stream and the matmul backend, and for
    pitch_shift on both of its stretch routes;
  * each channel within 1e-4 (interior max-rel) of the float64 reference
    pvbench/reference/pv64.py at 2.0x and 3.0x;
  * every other shape raises ValueError naming it, before any launch;
  * through a stub library (tests/test_torch_analysis_in_synth.py's), with
    meta tensors standing in for the card's, the span pv.channels at depth
    1 under the entry, and the counters channels.<wrapper>: C on the
    batch-axis launch, 1 a launch in the loop.

Marked `card` (skipped without a CUDA card): the same bits on the card at
2.0x and 3.0x for N = 512, 1024 and 2048, and at 2.0x exactly one
launches.fused_time_stretch_batch with channels.fused_time_stretch_batch
+= C. No JAX here, so that the card tests run where JAX is absent:

    python -m pytest tests/test_torch_channels.py --noconftest -m card
"""

import collections
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from phase_vocoder_tpu_torch import pipeline
from phase_vocoder_tpu_torch.bench import utterance
from phase_vocoder_tpu_torch.config import PvocConfig
from phase_vocoder_tpu_torch.ops import _build
from phase_vocoder_tpu_torch.utils import profiling
from pvbench.reference import pv64

SR = 16000


def _channels(c: int, seconds: float = 1.0) -> torch.Tensor:
    """(c, T) float32 made on the CPU: chip_smoke.py's signal with its own
    noise seed a channel, channel i delayed by 3 i samples."""
    n = int(seconds * SR)
    rows = [np.concatenate([np.zeros(3 * i), utterance(seconds, 10 + i, SR)])[:n] for i in range(c)]
    return torch.as_tensor(np.stack(rows).astype(np.float32))


def _assert_rows_are_single_calls(y, x, call):
    assert y.dim() == 2 and y.shape[0] == x.shape[0]
    for c in range(x.shape[0]):
        single = call(x[c].clone())
        assert torch.equal(y[c], single), c


# ------------------------------------------------------------- on the CPU


@pytest.mark.parametrize("channels", [1, 2, 8])
@pytest.mark.parametrize("ratio", [2.0, 3.0, 0.5])
def test_rows_are_the_single_calls(ratio, channels):
    x = _channels(channels)
    y = pipeline.time_stretch(x, ratio, device="cpu")
    _assert_rows_are_single_calls(y, x, lambda r: pipeline.time_stretch(r, ratio, device="cpu"))


@pytest.mark.parametrize("cfg,policy", [(PvocConfig(), "faithful"),
                                        (PvocConfig(fft_backend="matmul"), "auto")],
                         ids=["faithful_stream", "matmul_polar"])
def test_rows_are_the_single_calls_on_the_other_routes(cfg, policy):
    x = _channels(2)
    y = pipeline.time_stretch(x, 0.5, cfg, branch_policy=policy, device="cpu")
    _assert_rows_are_single_calls(
        y, x, lambda r: pipeline.time_stretch(r, 0.5, cfg, branch_policy=policy, device="cpu"))


@pytest.mark.parametrize("channels,semitones", [(2, -5.0), (2, 12.0), (2, 19.0), (8, 12.0)])
def test_pitch_shift_rows_are_the_single_calls(channels, semitones):
    x = _channels(channels)
    y = pipeline.pitch_shift(x, semitones, device="cpu")
    _assert_rows_are_single_calls(y, x, lambda r: pipeline.pitch_shift(r, semitones, device="cpu"))


@pytest.mark.parametrize("ratio", [2.0, 3.0])
def test_each_channel_is_near_the_float64_reference(ratio):
    x = _channels(3, seconds=2.0)
    y = pipeline.time_stretch(x, ratio, device="cpu")
    for c in range(x.shape[0]):
        ref = pv64.time_stretch(x[c], ratio, 1024, 256)
        assert pv64.max_rel_err(y[c], ref, 1024) < 1e-4, c


def test_a_contiguous_signal_is_taken_as_it_is():
    x = _channels(2)
    seen = []
    real = pipeline.fused_time_stretch_batch

    def spy(xs, *args):
        seen.append(xs)
        return real(xs, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "fused_time_stretch_batch", spy)
        y = pipeline.time_stretch(x, 2.0, device="cpu")
    assert len(seen) == 1 and seen[0] is x
    assert y.shape == (2, pipeline.stretch_output_length(x.shape[1], PvocConfig(), 2.0))


# ------------------------------------------- the stub library and meta tensors


class _Lib:
    @staticmethod
    def pvoc_cuda_error_string(rc):
        return b"an error"


@pytest.fixture
def stub(monkeypatch):
    """_build.launch with no card: a library whose TSM entries return 0,
    no device guard, a stream handle, check_cuda passing the meta tensors
    that stand in for the card's. An empty registry."""
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=profiling.RING))
    monkeypatch.setattr(profiling, "_counters", {})
    for entry in ("pvoc_fused", "pvoc_fused_batch", "resample_lerp"):
        monkeypatch.setattr(_Lib, entry, staticmethod(lambda *args: 0), raising=False)
    monkeypatch.setattr(_build, "kernels", lambda: _Lib)
    monkeypatch.setattr(_build, "_device_guard", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(_build, "_current_stream", lambda index: 0x5000)
    monkeypatch.setattr(_build, "check_cuda", lambda what, *tensors, dtype=None: None)


def _meta(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _entry_spans() -> list:
    """(name, depth) of the entry's spans, without the wrappers' own
    (pv.prepare, pv.launch:*), which must lie inside pv.channels where it
    was opened."""
    spans = [s for s in profiling.spans() if not s[0].startswith("pv.setup.")]
    inner = [s for s in spans if s[0] == "pv.prepare" or s[0].startswith("pv.launch:")]
    assert inner
    for name, depth, a, b in spans:
        if name == "pv.channels":
            assert all(depth < d and a <= c <= e <= b for _, d, c, e in inner)
    return [(s[0], s[1]) for s in spans if s not in inner]


@pytest.mark.parametrize("channels", [1, 8])
def test_the_batch_axis_launch_counts_its_channels(stub, channels):
    nf = 100
    x = _meta(channels, 1024 + (nf - 1) * 256)
    with profile(activities=[ProfilerActivity.CPU]):
        y = pipeline.time_stretch(x, 2.0)
    assert y.shape == (channels, (nf - 1) * 512 + 1024)
    assert _entry_spans() == [("pv.time_stretch", 0), ("pv.channels", 1), ("pv.route", 2)]
    assert profiling.counters() == {"launches.fused_time_stretch_batch": 1,
                                    "channels.fused_time_stretch_batch": channels,
                                    "frames_in_synth.fused_time_stretch_batch": channels * nf}


def test_a_loop_counts_one_channel_a_launch(stub):
    x = _meta(3, 1024 + 99 * 256)
    with profile(activities=[ProfilerActivity.CPU]):
        y = pipeline.time_stretch(x, 3.0)  # Rs > N/2: phasor_general_closed a channel
    assert y.shape == (3, 99 * 768 + 1024)
    assert _entry_spans() == [("pv.time_stretch", 0), ("pv.channels", 1), ("pv.route", 2)]
    assert profiling.counters() == {"launches.phasor_general_closed": 3,
                                    "channels.phasor_general_closed": 3,
                                    "frames_in_synth.phasor_general_closed": 300}


def test_pitch_shift_counts_its_stretch_and_each_row_of_its_resample(stub):
    x = _meta(4, 1024 + 99 * 256)
    with profile(activities=[ProfilerActivity.CPU]):
        pipeline.pitch_shift(x, 12.0)
    assert _entry_spans() == [("pv.pitch_shift", 0), ("pv.channels", 1), ("pv.route", 2)]
    got = profiling.counters()
    assert got["launches.fused_time_stretch_batch"] == 1
    assert got["channels.fused_time_stretch_batch"] == 4
    assert got["launches.resample_linear"] == got["channels.resample_linear"] == 4


def test_a_one_channel_recording_counts_no_channels(stub):
    with profile(activities=[ProfilerActivity.CPU]):
        pipeline.time_stretch(_meta(1024 + 99 * 256), 2.0)
    assert _entry_spans() == [("pv.time_stretch", 0), ("pv.route", 1)]
    assert not [k for k in profiling.counters() if k.startswith("channels.")]


@pytest.mark.parametrize("shape", [(0, 5000), (2, 2, 5000), ()])
@pytest.mark.parametrize("entry", ["time_stretch", "pitch_shift"])
def test_other_shapes_raise_before_any_launch(stub, entry, shape):
    fn = getattr(pipeline, entry)
    with pytest.raises(ValueError, match=str(shape).replace("(", r"\(").replace(")", r"\)")):
        fn(_meta(*shape), 2.0)
    assert profiling.counters() == {}


# ------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("ratio", [2.0, 3.0])
@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
def test_rows_are_the_single_calls_on_the_card(card, n_fft, ratio):
    cfg = PvocConfig(n_fft=n_fft, hop=n_fft // 4)
    x = _channels(8, seconds=30.0).to(card)
    y = pipeline.time_stretch(x, ratio, cfg)
    _assert_rows_are_single_calls(y, x, lambda r: pipeline.time_stretch(r, ratio, cfg))


@pytest.mark.card
def test_pitch_shift_rows_are_the_single_calls_on_the_card(card):
    x = _channels(2, seconds=30.0).to(card)
    for semitones in (-5.0, 12.0):
        y = pipeline.pitch_shift(x, semitones)
        _assert_rows_are_single_calls(y, x, lambda r: pipeline.pitch_shift(r, semitones))


@pytest.mark.card
@pytest.mark.parametrize("channels", [2, 8])
def test_one_launch_covers_every_channel_on_the_card(card, channels):
    x = _channels(channels, seconds=30.0).to(card)
    before = profiling.counters()
    pipeline.time_stretch(x, 2.0)
    after = profiling.counters()
    moved = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    assert {k: v for k, v in moved.items() if not k.startswith("frames_in_synth.")} == {
        "launches.fused_time_stretch_batch": 1, "channels.fused_time_stretch_batch": channels}
