"""The port's pipeline (time_stretch, pitch_shift, routing) on the CPU
against the JAX package with fft_backend="pallas" and the golden model.

Bounds: stretch < 5e-5 interior rel to JAX (two f32 paths, each ~1e-5 from
the golden model); pitch < 1e-4 to JAX (the resampler adds one f32
rounding on top); pitch < 1e-3 to the golden model, as
tests/test_pipeline.py holds the JAX package.
"""

import numpy as np
import pytest
import torch

from golden import pv_ref
import phase_vocoder_tpu as jpv
import phase_vocoder_tpu_torch as tpv
from phase_vocoder_tpu_torch import pipeline, streaming
from tests.conftest import make_test_signal

N, RA = 1024, 256
JAX_CFG = jpv.PvocConfig(fft_backend="pallas")


def rel_err(a, b, edge=N):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert len(a) == len(b), (len(a), len(b))
    sl = slice(edge, len(a) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


@pytest.fixture(scope="module")
def x1():
    return make_test_signal(1.0)


@pytest.mark.parametrize("stretch", [0.5, 1.0, 1.5, 2.0])
def test_time_stretch_vs_jax(stretch, x1):
    y = tpv.time_stretch(x1, stretch, device="cpu").numpy()
    j = np.asarray(jpv.time_stretch(x1, stretch, JAX_CFG))
    assert rel_err(y, j) < 5e-5


@pytest.mark.parametrize("semitones", [-12.0, -7.0, -5.0, 7.0, 12.0])
def test_pitch_shift_vs_jax(semitones, x1):
    y = tpv.pitch_shift(x1, semitones, device="cpu").numpy()
    j = np.asarray(jpv.pitch_shift(x1, semitones, JAX_CFG))
    assert rel_err(y, j) < 1e-4


@pytest.mark.parametrize("semitones", [-12.0, -7.0, -5.0, 7.0, 12.0])
def test_pitch_shift_vs_golden(semitones, x1):
    ref = pv_ref.pitch_shift(x1, semitones, N, RA)
    y = tpv.pitch_shift(x1, semitones, device="cpu").numpy()
    assert abs(len(y) - len(ref)) <= 1
    n = min(len(y), len(ref))
    assert rel_err(y[:n], ref[:n]) < 1e-3


def test_tensors_stay_on_their_device(x1):
    """A CPU tensor runs on the CPU even with the default device="cuda"."""
    y = tpv.time_stretch(torch.as_tensor(x1, dtype=torch.float32), 2.0)
    assert y.device.type == "cpu"
    assert len(y) == tpv.stretch_output_length(len(x1), tpv.PvocConfig(), 2.0)


def test_numpy_input_defaults_to_cuda(x1):
    """Non-tensor input goes to "cuda" unless told otherwise: never
    silently to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only build")
    with pytest.raises((RuntimeError, AssertionError)):
        tpv.time_stretch(x1, 2.0)


def test_model_facade(x1):
    pv = tpv.PhaseVocoder(device="cpu")
    assert isinstance(pv, torch.nn.Module)
    assert torch.equal(pv(x1, 2.0), tpv.time_stretch(x1, 2.0, device="cpu"))
    assert torch.equal(pv.pitch_shift(x1, 7.0), tpv.pitch_shift(x1, 7.0, device="cpu"))
    assert pv.output_length(len(x1), 2.0) == tpv.stretch_output_length(
        len(x1), pv.config, 2.0
    )


def test_short_input_gives_empty_output():
    assert tpv.time_stretch(np.zeros(100), 2.0, device="cpu").shape == (0,)
    assert tpv.pitch_shift(np.zeros(100), 7.0, device="cpu").shape == (0,)


# ------------------------------------------------------------------ routing


@pytest.fixture
def no_compute(monkeypatch):
    """Fail the test if a route reaches the fused kernel wrapper."""

    def boom(*a, **k):
        raise AssertionError("reached fused_time_stretch")

    monkeypatch.setattr(pipeline, "fused_time_stretch", boom)


@pytest.fixture
def stream_calls(monkeypatch):
    """Replace the streaming executor with a recorder that returns a zero
    waveform of the right length; returns the list of its calls."""
    calls = []

    def fake(x, stretch, cfg=tpv.PvocConfig(), **kw):
        calls.append((stretch, cfg))
        return torch.zeros(tpv.stretch_output_length(x.shape[-1], cfg, stretch))

    monkeypatch.setattr(streaming, "stream_time_stretch", fake)
    return calls


def _frames_to_samples(nf):
    return (nf - 1) * RA + N


def test_auto_reroutes_long_q2_inputs(no_compute, stream_calls):
    """Past BRANCH_FAITHFUL_FRAMES a q >= 2 ratio takes the branch-faithful
    streaming executor, and its result is what time_stretch returns (and
    what pitch_shift resamples)."""
    x = torch.zeros(_frames_to_samples(pipeline.BRANCH_FAITHFUL_FRAMES + 1))
    y = tpv.time_stretch(x, 0.5)
    assert torch.equal(y, torch.zeros(tpv.stretch_output_length(len(x), tpv.PvocConfig(), 0.5)))
    p = tpv.pitch_shift(x, -7.0)
    f = 2.0 ** (-7 / 12)
    assert len(p) == round(tpv.stretch_output_length(len(x), tpv.PvocConfig(), f) / f)
    assert [c[0] for c in stream_calls] == [0.5, f]


def test_auto_keeps_short_and_integer_k_inputs(monkeypatch):
    calls = []
    monkeypatch.setattr(pipeline, "fused_time_stretch", lambda *a: calls.append(a[1:]) or a[0])
    at_limit = torch.zeros(_frames_to_samples(pipeline.BRANCH_FAITHFUL_FRAMES))
    tpv.time_stretch(at_limit, 0.5)
    long = torch.zeros(_frames_to_samples(pipeline.BRANCH_FAITHFUL_FRAMES + 1))
    tpv.time_stretch(long, 2.0)  # integer k never reroutes
    tpv.time_stretch(long, 0.5, branch_policy="fast")
    assert calls == [(N, RA, 128), (N, RA, 512), (N, RA, 128)]


def test_faithful_reroutes_every_q2_input(no_compute, stream_calls, x1):
    y = tpv.time_stretch(x1, 0.5, branch_policy="faithful", device="cpu")
    assert torch.equal(y, torch.zeros(tpv.stretch_output_length(len(x1), tpv.PvocConfig(), 0.5)))
    tpv.pitch_shift(x1, -7.0, branch_policy="faithful", device="cpu")
    assert [c[0] for c in stream_calls] == [0.5, 2.0 ** (-7 / 12)]


def test_rs_above_half_n_raises(no_compute, monkeypatch, x1):
    """Rs = 640 > N/2 no longer raises: below both frame limits it takes
    the general-hop phasor route, as the JAX package does, and matches it."""
    routes = []
    general = pipeline.phasor_general_stretch
    monkeypatch.setattr(
        pipeline, "phasor_general_stretch",
        lambda x, cfg, rs: routes.append(rs) or general(x, cfg, rs),
    )
    y = tpv.time_stretch(x1, 2.5, device="cpu").numpy()
    assert routes == [640]
    j = np.asarray(jpv.time_stretch(x1, 2.5, JAX_CFG))
    assert rel_err(y, j) < 5e-5


def test_rs_above_half_n_streams_past_both_limits(no_compute, stream_calls):
    """The JAX package streams Rs > N/2 inputs longer than both
    max_monolithic_frames and max_phasor_general_frames."""
    x = torch.zeros(_frames_to_samples(300))
    tpv.time_stretch(x, 2.5, max_monolithic_frames=100, max_phasor_general_frames=200)
    assert [c[0] for c in stream_calls] == [2.5]


def test_unported_geometry_raises(no_compute, x1):
    """What the fused backend's kernels do not take raises before any
    compute: n_fft above 4096 (odd n_fft is refused by the config)."""
    cfg = tpv.PvocConfig(n_fft=8192, hop=2048)
    with pytest.raises(NotImplementedError, match="4096"):
        tpv.time_stretch(x1, 2.0, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="4096"):
        tpv.time_stretch(x1, 0.5, cfg, branch_policy="faithful", device="cpu")
    with pytest.raises(ValueError, match="even"):
        tpv.PvocConfig(n_fft=1535, hop=307)


@pytest.mark.parametrize("backend", ["matmul", "xla"])
def test_polar_backends_raise(backend, monkeypatch, no_compute, stream_calls, x1):
    """The polar backends route as in the JAX package: short inputs to the
    monolithic polar path, inputs past max_monolithic_frames to the
    streaming executor, neither to the fused kernel."""
    cfg = tpv.PvocConfig(fft_backend=backend)
    polar = []
    monkeypatch.setattr(pipeline, "_polar_stretch", lambda x, c, rs: polar.append(rs) or x)
    tpv.time_stretch(x1, 2.0, cfg, device="cpu")
    tpv.time_stretch(x1, 2.0, cfg, max_monolithic_frames=10, device="cpu")
    assert polar == [512] and [c[0] for c in stream_calls] == [2.0]


def test_unknown_backend_and_dtype():
    with pytest.raises(ValueError):
        tpv.PvocConfig(fft_backend="pallas")
    with pytest.raises(NotImplementedError):
        tpv.PvocConfig(dtype="bfloat16")


def test_bogus_branch_policy_raises_like_jax(x1):
    with pytest.raises(ValueError):
        jpv.time_stretch(x1, 2.0, JAX_CFG, branch_policy="bogus")
    with pytest.raises(ValueError):
        tpv.time_stretch(x1, 2.0, branch_policy="bogus", device="cpu")


def test_config_mirrors_jax():
    a, b = tpv.PvocConfig(), jpv.PvocConfig()
    assert (a.n_fft, a.hop, a.sample_rate, a.n_bins) == (b.n_fft, b.hop, b.sample_rate, b.n_bins)
    for s in (0.5, 0.6674, 1.0, 1.5, 2.0):
        assert a.synthesis_hop(s) == b.synthesis_hop(s)
    with pytest.raises(ValueError):
        tpv.PvocConfig(n_fft=1023)
    with pytest.raises(ValueError):
        a.synthesis_hop(0.001)
