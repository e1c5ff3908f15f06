"""The port at FFT sizes that are not powers of two (N = 768, 1000, 1536,
896, each with hop N/4), on the CPU through the kernels' plain versions,
against the JAX package (PvocConfig(fft_backend="pallas"), its kernels in
interpret mode) and the float64 golden model; the matmul fallback where
the hop does not divide N; and the sizes that still raise.

Bounds, the ones the power-of-two tests hold:
  * fused TSM, fused stream, time_stretch: <= 5e-5 interior rel to JAX,
    < 1e-4 to golden (edges skipped: N samples);
  * pitch_shift: < 1e-4 to JAX, < 1e-3 to golden;
  * fused stream and batch rows vs the single-recording plain TSM:
    torch.equal;
  * stft_phasor_terms: |X| within 2e-6 of max |X|, phasors within 1e-4
    once weighted by |X|/max |X|; phasor_istft_ola and the polar stages
    (analyze, stretch_polar, synthesize_polar): <= 5e-5 interior rel to
    JAX's;
  * the state of the JAX package's fused stream after one segment,
    converted, continues the port's loop within 5e-5 of its own run;
  * (N, hop) = (1024, 320): analysis through the matmul DFT as in the JAX
    package, <= 5e-5 to it and < 1e-4 to golden.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import pv_ref
import phase_vocoder_tpu as jpv
from phase_vocoder_tpu import pipeline as jpipeline
from phase_vocoder_tpu import streaming as jstreaming
from phase_vocoder_tpu.ops.pallas import fused as jfused
from phase_vocoder_tpu.utils.checkpoint import _fused_state_to_tree
import phase_vocoder_tpu_torch as tpv
from phase_vocoder_tpu_torch import pipeline, streaming
from phase_vocoder_tpu_torch.ops import fused, stft
from phase_vocoder_tpu_torch.utils.checkpoint import fused_stream_state_from_jax_tree
from tests.conftest import make_test_signal

SIZES = [(768, 192), (1000, 250), (1536, 384), (896, 224)]


def rel_err(a, b, edge):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert len(a) == len(b), (len(a), len(b))
    sl = slice(edge, len(a) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


def cfgs(n, hop):
    return tpv.PvocConfig(n_fft=n, hop=hop), jpv.PvocConfig(n_fft=n, hop=hop, fft_backend="pallas")


@pytest.fixture(scope="module")
def x2():
    return make_test_signal(2.0).astype(np.float32)


@pytest.fixture(scope="module")
def x4():
    return make_test_signal(4.0).astype(np.float32)


@pytest.mark.parametrize("stretch", [2.0, 0.5, 171 / 256])
@pytest.mark.parametrize("n,hop", SIZES)
def test_fused_vs_jax_and_golden(n, hop, stretch, x2):
    rs = int(round(hop * stretch))
    assert fused.phasor_supported(n, hop, rs)
    y = fused.fused_time_stretch(torch.as_tensor(x2), n, hop, rs).numpy()
    j = np.asarray(jfused.fused_time_stretch(x2, n, hop, rs))
    ref = pv_ref.phase_vocoder(x2.astype(np.float64), rs / hop, n, hop)
    assert rel_err(y, j, n) <= 5e-5
    assert rel_err(y, ref, n) < 1e-4


@pytest.mark.parametrize("stretch", [2.0, 0.5])
@pytest.mark.parametrize("n,hop", SIZES)
def test_time_stretch_vs_jax(n, hop, stretch, x2):
    cfg, jcfg = cfgs(n, hop)
    y = tpv.time_stretch(x2, stretch, cfg, device="cpu").numpy()
    j = np.asarray(jpv.time_stretch(x2, stretch, jcfg))
    assert rel_err(y, j, n) <= 5e-5


@pytest.mark.parametrize("n,hop", SIZES)
def test_pitch_shift_vs_jax_and_golden(n, hop, x2):
    cfg, jcfg = cfgs(n, hop)
    y = tpv.pitch_shift(x2, -7.0, cfg, device="cpu").numpy()
    j = np.asarray(jpv.pitch_shift(x2, -7.0, jcfg))
    ref = pv_ref.pitch_shift(x2.astype(np.float64), -7.0, n, hop)
    assert rel_err(y, j, n) < 1e-4
    assert abs(len(y) - len(ref)) <= 1
    m = min(len(y), len(ref))
    assert rel_err(y[:m], ref[:m], n) < 1e-3


@pytest.mark.parametrize("stretch", [2.0, 0.5, 171 / 256])
@pytest.mark.parametrize("n,hop", SIZES)
def test_stream_bitwise_matches_monolithic(n, hop, stretch, x4):
    cfg, _ = cfgs(n, hop)
    rs = cfg.synthesis_hop(stretch)
    x = torch.as_tensor(x4)
    mono = fused.fused_time_stretch_reference(x, n, hop, rs)
    strm = streaming.fused_stream_time_stretch(x, stretch, cfg, segment_frames=128)
    assert torch.equal(strm, mono)


@pytest.mark.parametrize("n,hop", SIZES)
def test_stream_vs_jax_fused_stream(n, hop, x4):
    cfg, jcfg = cfgs(n, hop)
    y = streaming.fused_stream_time_stretch(x4, 2.0, cfg, segment_frames=128, device="cpu").numpy()
    j = np.asarray(jstreaming.fused_stream_time_stretch(x4, 2.0, jcfg, segment_frames=128))
    assert rel_err(y, j, n) <= 5e-5


@pytest.mark.parametrize("n,hop", SIZES)
def test_batch_rows_bitwise_and_vs_jax(n, hop, x2):
    """A ragged batch: each row equals the single-recording plain TSM on
    its own signal bit for bit, and the JAX batched kernel within 5e-5."""
    rs = 2 * hop
    lens = [len(x2), len(x2) - 3 * hop - 17, n + hop]
    xs = np.zeros((3, len(x2)), np.float32)
    for i, m in enumerate(lens):
        xs[i, :m] = x2[i * 100 : i * 100 + m]
    nfs = [(m - n) // hop + 1 for m in lens]
    out = fused.fused_time_stretch_batch(torch.as_tensor(xs), n, hop, rs, nfs)
    j = np.asarray(jfused.fused_time_stretch_batch(jnp.asarray(xs), n, hop, rs,
                                                   n_valid_frames=jnp.asarray(nfs)))
    for b, nf_b in enumerate(nfs):
        n_out = (nf_b - 1) * rs + n
        one = fused.fused_time_stretch(torch.as_tensor(xs[b, : lens[b]]), n, hop, rs)
        assert torch.equal(out[b, :n_out], one)
        assert not out[b, n_out:].any()
        if nf_b > 8:
            assert rel_err(out[b, :n_out].numpy(), j[b, :n_out], n) <= 5e-5


@pytest.mark.parametrize("n,hop", SIZES)
def test_phasor_terms_and_synthesis_vs_jax(n, hop, x2):
    """stft_phasor_terms at Rs = hop/2 (scan on), then phasor_istft_ola of
    those phasors, each against the JAX function on the same inputs."""
    rs, nb = hop // 2, n // 2 + 1
    jt = jfused.stft_phasor_terms(jnp.asarray(x2), n, hop, rs, scan=True)
    nf = jt[-1]
    jm, jpre, jpim = (np.asarray(a)[:nf, :nb] for a in jt[:3])
    t = fused.stft_phasor_terms(torch.as_tensor(x2), n, hop, rs, scan=True)
    assert t[-1] == nf and t[0].shape == (nf, nb)
    top = np.abs(jm).max()
    assert np.abs(t[0].numpy() - jm).max() / top <= 2e-6
    dp = np.abs((t[1].numpy() + 1j * t[2].numpy()) - (jpre + 1j * jpim))
    assert np.max(dp * jm / top) <= 1e-4
    assert n % rs == 0
    y = fused.phasor_istft_ola(t[0], t[1], t[2], n, rs, nf).numpy()
    jy = np.asarray(jfused.phasor_istft_ola(jt[0], jt[1], jt[2], n, rs, nf))
    assert rel_err(y, jy, n) <= 5e-5


@pytest.mark.parametrize("n,hop", SIZES)
def test_polar_stages_vs_jax(n, hop, x2):
    """analyze, stretch_polar and synthesize_polar on the fused backend at
    an Rs that does not divide N (istft_frames) and one that does
    (istft_ola)."""
    cfg, jcfg = cfgs(n, hop)
    x = torch.as_tensor(x2)
    assert pipeline.fused_analysis_ok(cfg)
    for rs in (int(round(hop * 2 ** (-7 / 12))), hop // 2):
        mag, phi = pipeline.analyze(x, cfg)
        mag, psi = pipeline.stretch_polar(mag, phi, cfg, rs)
        y = pipeline.synthesize_polar(mag, psi, cfg, rs).numpy()
        jm, jphi = jpipeline.analyze(jnp.asarray(x2), jcfg)
        jm, jpsi = jpipeline.stretch_polar(jm, jphi, jcfg, rs)
        j = np.asarray(jpipeline.synthesize_polar(jm, jpsi, jcfg, rs))
        assert pipeline.fused_synthesis_ok(cfg, rs) == (n % rs == 0)
        assert rel_err(y, j, n) <= 5e-5


def test_resume_from_jax_state_at_768(x4):
    """The carry is (4, N/2 - 1) at any even N: the JAX fused stream's
    state after one segment at N = 768, converted, continues the port's
    loop."""
    n, hop, rs = 768, 192, 384
    x = torch.as_tensor(x4)
    nf = fused.num_frames(len(x), n, hop)
    tile = jfused._pick_tile(n, rs, nf)
    F, S = jstreaming.fused_plan_segments(nf, n, rs, 128, tile)
    assert S >= 2 and F % fused.SCAN_CHUNK == 0
    rows = jstreaming.fused_stream_rows(jnp.asarray(x4), n, hop, F, S, tile)
    _, jstate = jstreaming._fused_scan_from(rows, jstreaming.fused_init_state(n, rs), nf, n, hop, rs, F, 1)
    tree = {name: np.asarray(v) for name, v in _fused_state_to_tree(jstate).items()}
    state = fused_stream_state_from_jax_tree(tree, n, rs)
    assert state.carry.shape == (4, n // 2 - 1) and state.tail.shape == (n // rs - 1, rs)
    assert state.frame_offset == F and state.started == 1
    whole, _ = streaming._fused_scan_from(x, streaming.fused_init_state(n, rs), nf, n, hop, rs, F, S)
    resumed, _ = streaming._fused_scan_from(x, state, nf, n, hop, rs, F, S - 1)
    n_out = (nf - 1) * rs + n - F * rs
    assert rel_err(resumed[:n_out].numpy(), whole[F * rs :][:n_out].numpy(), 64) <= 5e-5


def test_port_holds_the_gate_where_the_jax_kernel_drifts_at_1536():
    """At N = 1536, k = 2, on the seed-20 test signal the JAX fused kernel
    reads 1.4e-4 from the golden model (its matrix DFT against the anchor
    phases of quiet bins; above its own 1e-4 gate), the port 9e-6: the two
    packages are 1.5e-4 apart there, which is the reference's share."""
    x = make_test_signal(2.0, seed=20).astype(np.float32)
    ref = pv_ref.phase_vocoder(x.astype(np.float64), 2.0, 1536, 384)
    y = fused.fused_time_stretch(torch.as_tensor(x), 1536, 384, 768).numpy()
    j = np.asarray(jfused.fused_time_stretch(x, 1536, 384, 768))
    assert rel_err(y, ref, 1536) < 1e-4
    assert rel_err(y, ref, 1536) < rel_err(j, ref, 1536)


# ---------------------------------------- hop does not divide N: the fallback


@pytest.mark.parametrize("stretch", [2.0, 0.5, 1.6])
def test_hop_not_dividing_n_takes_the_matmul_analysis(stretch, x2, monkeypatch):
    """(1024, 320) on the fused backend: no kernel frames the signal, so
    the analysis is the matmul DFT, as in the JAX package under "pallas";
    the synthesis stays on the kernels' plain versions (istft_ola at
    Rs = 512, istft_frames at Rs = 640 and 160)."""
    cfg, jcfg = cfgs(1024, 320)
    assert not pipeline.fused_analysis_ok(cfg) and not pipeline.fused_ok(cfg, 160)
    seen = []
    real = pipeline.fft_ops.rfft
    monkeypatch.setattr(pipeline.fft_ops, "rfft",
                        lambda *a, **k: seen.append(k.get("backend")) or real(*a, **k))
    y = tpv.time_stretch(x2, stretch, cfg, device="cpu").numpy()
    assert seen == ["matmul"]
    j = np.asarray(jpv.time_stretch(x2, stretch, jcfg))
    ref = pv_ref.phase_vocoder(x2.astype(np.float64), cfg.synthesis_hop(stretch) / 320, 1024, 320)
    assert rel_err(y, j, 1024) <= 5e-5
    assert rel_err(y, ref, 1024) < 1e-4


def test_hop_not_dividing_n_pitch_and_route(x2):
    cfg, jcfg = cfgs(1024, 320)
    assert pipeline._route(cfg, 640, 100, "auto") == "polar"
    assert pipeline._route(cfg, 160, 100, "faithful") == "stream"
    y = tpv.pitch_shift(x2, -7.0, cfg, device="cpu").numpy()
    j = np.asarray(jpv.pitch_shift(x2, -7.0, jcfg))
    assert rel_err(y, j, 1024) < 1e-4


# ------------------------------------------------------------ what still raises


@pytest.mark.parametrize("n,hop", [(8192, 2048), (4098, 683)])
def test_n_above_4096_raises_naming_the_limit(n, hop, x2):
    cfg = tpv.PvocConfig(n_fft=n, hop=hop)
    with pytest.raises(NotImplementedError, match="4096"):
        tpv.time_stretch(x2, 2.0, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="4096"):
        tpv.pitch_shift(x2, -7.0, cfg, device="cpu")
    with pytest.raises(ValueError, match="4096"):
        fused.fused_time_stretch(torch.as_tensor(x2), n, hop, hop)
    with pytest.raises(ValueError, match="4096"):
        stft.istft_frames(torch.zeros((4, n // 2 + 1)), torch.zeros((4, n // 2 + 1)), n)
    assert not fused.fft_size_supported(n)


@pytest.mark.parametrize("n", [1023, 767, 1])
def test_odd_n_raises(n, x2):
    with pytest.raises(ValueError, match="even"):
        tpv.PvocConfig(n_fft=n, hop=max(n // 3, 1))
    assert not fused.fft_size_supported(n)
    assert not fused.phasor_supported(n, max(n // 3, 1), max(n // 3, 1))
    with pytest.raises(ValueError, match="even"):
        fused.fused_time_stretch(torch.as_tensor(x2), n, max(n // 3, 1), max(n // 3, 1))


@pytest.mark.parametrize("n", [2, 6, 768, 1000, 2018, 4094, 4096])
def test_every_even_n_up_to_4096_is_taken(n):
    assert fused.fft_size_supported(n)
    assert stft.stft_supported(n, n // 2)
    assert fused.synth_supported(n, n // 2) and fused.phasor_terms_supported(n, n // 2, n)
