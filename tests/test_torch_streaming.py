"""The port's branch-faithful polar route (streaming.py and the routing of
pipeline.py) on the CPU, against the JAX package's polar streaming executor
(PvocConfig(fft_backend="pallas"), its kernels in interpret mode) and the
float64 golden model.

Bounds:
  * stream vs JAX's stream <= 1e-5 interior rel: both run the same polar
    formula and the bitwise-equal phase scan (tests/test_torch_phase.py);
    they differ only by the f32 rounding of the analysis DFT (torch.fft vs
    a matrix DFT) and the synthesis, ~2e-6 measured at 4 s.
  * vs golden < 1e-4 (stretch) and < 1e-3 (pitch), the repository's gates.
  * stream vs the monolithic polar path < 5e-5, the JAX package's own
    bound for the same comparison (tests/test_streaming.py).
  * the polar backends' time_stretch vs JAX's same backend < 5e-5 (two f32
    paths, each ~1e-5 from golden, as tests/test_torch_pipeline.py).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from golden import pv_ref
import phase_vocoder_tpu as jpv
from phase_vocoder_tpu.streaming import stream_time_stretch as jax_stream
import phase_vocoder_tpu_torch as tpv
from phase_vocoder_tpu_torch import pipeline, streaming
from tests.conftest import make_test_signal

N, RA = 1024, 256
JAX_CFG = jpv.PvocConfig(fft_backend="pallas")
CFG = tpv.PvocConfig()


def rel_err(a, b, edge=N):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert len(a) == len(b), (len(a), len(b))
    sl = slice(edge, len(a) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


@pytest.fixture(scope="module")
def x4():
    return make_test_signal(4.0).astype(np.float32)


@pytest.fixture(scope="module")
def x1():
    return make_test_signal(1.0).astype(np.float32)


def _stream(x, stretch, cfg=CFG, **kw):
    return streaming.stream_time_stretch(x, stretch, cfg, device="cpu", **kw).numpy()


# ------------------------------------------------------- stream vs the JAX one


@pytest.mark.parametrize("stretch,segment_frames", [(0.5, 13), (0.5, 40), (2.0, 40), (1.5, 13)])
def test_stream_vs_jax(stretch, segment_frames, x4):
    y = _stream(x4, stretch, segment_frames=segment_frames)
    j = np.asarray(jax_stream(x4, stretch, JAX_CFG, segment_frames=segment_frames))
    assert rel_err(y, j) <= 1e-5


def test_stream_exact_segment_boundary_vs_jax():
    """160 frames in 10 segments of 16."""
    x = make_test_signal((N + RA * 159) / 16000).astype(np.float32)
    y = _stream(x, 0.5, segment_frames=16)
    j = np.asarray(jax_stream(x, 0.5, JAX_CFG, segment_frames=16))
    assert rel_err(y, j) <= 1e-5


def test_stream_single_segment_vs_jax(x1):
    """A segment larger than the recording: one masked segment."""
    y = _stream(x1, 0.5, segment_frames=4096)
    j = np.asarray(jax_stream(x1, 0.5, JAX_CFG, segment_frames=4096))
    assert rel_err(y, j) <= 1e-5


@pytest.mark.parametrize("stretch", [0.5, 2.0])
def test_stream_vs_golden(stretch, x1):
    y = _stream(x1, stretch, segment_frames=13)
    ref = pv_ref.phase_vocoder(x1.astype(np.float64), stretch, N, RA)
    assert rel_err(y, ref) < 1e-4


@pytest.mark.parametrize("stretch", [0.5, 1.0, 2.0])
def test_stream_vs_monolithic_polar(stretch, x4):
    """The segment loop against the same polar formula in one pass over
    the whole recording (analyze -> stretch_polar -> synthesize_polar)."""
    rs = CFG.synthesis_hop(stretch)
    mono = pipeline._polar_stretch(torch.as_tensor(x4), CFG, rs).numpy()
    y = _stream(x4, stretch, segment_frames=40)
    assert len(y) == len(mono)
    assert rel_err(y, mono) < 5e-5


def test_stream_resumes_from_any_state(x4):
    """_stream_scan_from started from the state after k segments continues
    bitwise where the one-call run goes (the checkpoint granularity)."""
    x = torch.as_tensor(x4)
    rs, nf = 128, pipeline.framing.num_frames(len(x4), N, RA)
    F, S = streaming.plan_segments(nf, CFG, rs, 40)
    x_pad = streaming.pad_for_segments(x, CFG, F, S)
    s0 = streaming.init_state(CFG, rs)
    whole, end = streaming._stream_scan_from(x_pad, s0, nf, CFG, rs, F, S)
    head, mid = streaming._stream_scan_from(x_pad, s0, nf, CFG, rs, F, 2)
    tail, end2 = streaming._stream_scan_from(x_pad, mid, nf, CFG, rs, F, S - 2)
    assert int(mid.frame_offset) == 2 * F and bool(mid.started)
    assert torch.equal(torch.cat([head, tail]), whole)
    assert torch.equal(end.ola_tail, end2.ola_tail) and int(end2.frame_offset) == nf


def test_segment_step_reads_host_values_from_the_state(x1):
    """Called alone, segment_step takes the frame offset and the started
    flag from the state; the loop passes them as host values."""
    x = torch.as_tensor(x1)
    F = 13
    seg = x[: F * RA + N - RA]
    s0 = streaming.init_state(CFG, 128)
    a, sa = streaming.segment_step(seg, F, s0, CFG, 128)
    b, sb = streaming.segment_step(seg, F, s0, CFG, 128, frame_offset=0, started=False)
    assert torch.equal(a, b) and torch.equal(sa.psi_carry, sb.psi_carry)
    assert int(sa.frame_offset) == F


def test_init_state_rejects_rs_above_n():
    with pytest.raises(ValueError):
        streaming.init_state(CFG, N + 1)


def test_numpy_input_defaults_to_cuda(x1):
    """On the faithful route too, non-tensor input goes to "cuda" unless
    told otherwise: never silently to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only build")
    with pytest.raises((RuntimeError, AssertionError)):
        tpv.time_stretch(x1, 0.5, branch_policy="faithful")
    with pytest.raises((RuntimeError, AssertionError)):
        streaming.stream_time_stretch(x1, 0.5)


def test_stream_short_input_gives_empty_output():
    assert streaming.stream_time_stretch(np.zeros(100), 0.5, device="cpu").shape == (0,)


# ------------------------------------------------------------------ routes


def test_branch_faithful_routing(x4):
    """Twin of tests/test_longform.py test_branch_faithful_routing:
    "faithful" equals stream_time_stretch bitwise and holds the golden gate;
    "fast" keeps the fused kernel; integer k is a no-op."""
    ref = pv_ref.phase_vocoder(x4.astype(np.float64), 0.5, N, RA)
    y_faith = tpv.time_stretch(x4, 0.5, branch_policy="faithful", device="cpu").numpy()
    assert np.array_equal(y_faith, _stream(x4, 0.5))
    assert rel_err(y_faith, ref) < 1e-4
    y_fast = tpv.time_stretch(x4, 0.5, branch_policy="fast", device="cpu").numpy()
    assert rel_err(y_fast, ref) < 1e-4
    a = tpv.time_stretch(x4, 2.0, branch_policy="faithful", device="cpu")
    b = tpv.time_stretch(x4, 2.0, branch_policy="fast", device="cpu")
    assert torch.equal(a, b)


@pytest.mark.parametrize("stretch", [0.5, 1.5])
def test_faithful_time_stretch_vs_jax_and_golden(stretch, x4):
    y = tpv.time_stretch(x4, stretch, branch_policy="faithful", device="cpu").numpy()
    j = np.asarray(jax_stream(x4, stretch, JAX_CFG))
    assert rel_err(y, j) <= 1e-5
    ref = pv_ref.phase_vocoder(x4.astype(np.float64), stretch, N, RA)
    assert rel_err(y, ref) < 1e-4


@pytest.mark.parametrize("semitones", [-7.0, -5.0])
def test_faithful_pitch_shift_vs_jax_and_golden(semitones, x4):
    """The stretch stage on the faithful executor, then the resampler (the
    JAX package's resampler on its side)."""
    y = tpv.pitch_shift(x4, semitones, branch_policy="faithful", device="cpu").numpy()
    j = np.asarray(jpv.pitch_shift(x4, semitones, JAX_CFG, branch_policy="faithful"))
    assert rel_err(y, j) <= 1e-5
    ref = pv_ref.pitch_shift(x4.astype(np.float64), semitones, N, RA)
    assert abs(len(y) - len(ref)) <= 1
    n = min(len(y), len(ref))
    assert rel_err(y[:n], ref[:n]) < 1e-3


@pytest.mark.parametrize("backend", ["matmul", "xla"])
@pytest.mark.parametrize("stretch", [0.5, 1.0, 2.0])
def test_polar_backends_vs_jax(backend, stretch, x1):
    y = tpv.time_stretch(x1, stretch, tpv.PvocConfig(fft_backend=backend), device="cpu").numpy()
    j = np.asarray(jpv.time_stretch(x1, stretch, jpv.PvocConfig(fft_backend=backend)))
    assert rel_err(y, j) < 5e-5


@pytest.mark.parametrize("backend", ["matmul", "xla"])
def test_polar_backend_pitch_shift_vs_golden(backend, x1):
    y = tpv.pitch_shift(x1, -7.0, tpv.PvocConfig(fft_backend=backend), device="cpu").numpy()
    ref = pv_ref.pitch_shift(x1.astype(np.float64), -7.0, N, RA)
    n = min(len(y), len(ref))
    assert rel_err(y[:n], ref[:n]) < 1e-3


def test_polar_scatter_ola_holds_the_golden_gate(x1):
    ref = pv_ref.phase_vocoder(x1.astype(np.float64), 2.0, N, RA)
    cfg = tpv.PvocConfig(fft_backend="matmul", ola_method="scatter")
    y = tpv.time_stretch(x1, 2.0, cfg, device="cpu").numpy()
    assert rel_err(y, ref) < 1e-4


def test_polar_cumsum_no_worse_than_jax(x1):
    """phase_method="cumsum" keeps the unwrapped running phase in float32,
    whose rounding at |psi| ~ 1e5 rad drifts past the 1e-4 gate within a
    second of audio in both packages (JAX: 1.0e-3 here); the port's must be
    no worse than the JAX package's on the same input."""
    ref = pv_ref.phase_vocoder(x1.astype(np.float64), 2.0, N, RA)
    y = tpv.time_stretch(x1, 2.0, tpv.PvocConfig(fft_backend="matmul", phase_method="cumsum"),
                         device="cpu").numpy()
    j = np.asarray(jpv.time_stretch(x1, 2.0, jpv.PvocConfig(fft_backend="matmul",
                                                            phase_method="cumsum")))
    assert rel_err(y, ref) <= rel_err(j, ref)


def test_synthesize_polar_on_fused_backend_with_general_hop_raises(x1):
    """Rs = 171 does not divide N: on the fused backend synthesize_polar
    now runs the istft_frames kernel's plain version and fold OLA instead
    of raising, and matches the "matmul" backend's synthesis (same formula,
    torch.fft vs an FP32 matrix inverse DFT)."""
    mag, phi = pipeline.analyze(torch.as_tensor(x1), CFG)
    mag, psi = pipeline.stretch_polar(mag, phi, CFG, 171)
    y = pipeline.synthesize_polar(mag, psi, CFG, 171).numpy()
    ref = pipeline.synthesize_polar(mag, psi, tpv.PvocConfig(fft_backend="matmul"), 171).numpy()
    assert len(y) == (mag.shape[0] - 1) * 171 + N
    assert rel_err(y, ref) < 1e-5


# -------------------------------------------------------- facade and CLI


def test_facade_stream_equals_streaming(x1):
    pv = tpv.PhaseVocoder(device="cpu")
    assert torch.equal(pv.stream_time_stretch(x1, 0.5, segment_frames=40),
                       streaming.stream_time_stretch(x1, 0.5, segment_frames=40, device="cpu"))


@pytest.fixture(scope="module")
def wav2(tmp_path_factory):
    x = make_test_signal(2.0).astype(np.float32)
    path = tmp_path_factory.mktemp("wav") / "in.wav"
    wavfile.write(path, 16000, x)
    return path, x


@pytest.mark.parametrize("extra", [["--branch-policy", "faithful"], ["--segment-frames", "40"]])
def test_cli_faithful_stretch_matches_golden(extra, wav2, tmp_path):
    path, x = wav2
    out = tmp_path / "out.wav"
    proc = subprocess.run(
        [sys.executable, "-m", "phase_vocoder_tpu_torch.cli", "stretch", str(path), str(out),
         "--ratio", "0.5", "--float32", "--device", "cpu", *extra],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    _, y = wavfile.read(out)
    ref = pv_ref.phase_vocoder(x.astype(np.float64), 0.5, N, RA)
    assert len(y) == len(ref)
    assert rel_err(y, ref) < 1e-4
