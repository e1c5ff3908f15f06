"""The port's general-hop phasor route (pipeline.phasor_general_stretch: the
stft_phasor_terms and istft_frames_cart kernels, fold overlap-add) and the
polar frames kernel (istft_frames, synthesize_polar at Rs not dividing N)
on the CPU, through their plain versions, against the JAX package
(PvocConfig(fft_backend="pallas"), its kernels in interpret mode) and the
float64 golden model.

Bounds:
  * stft_phasor_terms: |X| within 2e-6 of JAX's max |X| (torch.fft vs the
    JAX kernel's matrix DFT); the phasors (u, the terms, the scanned P)
    within 1e-4 once weighted by |X|/max |X|. Unweighted they differ up to
    ~1e-3 in near-silent bins, where the phase of X is ill-conditioned in
    both packages; the weight is what the synthesis sees (Y = |X| P);
  * istft_frames(_cart): 1e-4 of the largest frame sample (JAX's inverse
    DFT is a 3-pass bf16 split, ~2^-17 per operand);
  * time_stretch at 2.5x / 3.0x: <= 5e-5 interior rel to JAX (measured
    2.6e-5 / 3.4e-5 at 4 s) and < 1e-4 to golden; pitch_shift +19 st
    (Rs = 767, the angle domain): < 1e-4 to JAX and < 1e-3 to golden, as
    tests/test_torch_pipeline.py holds pitch shifts;
  * synthesize_polar at Rs = 171 on the fused backend: <= 5e-5 interior
    rel to JAX's (same formula; the inverse DFTs differ as above).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import pv_ref
import phase_vocoder_tpu as jpv
from phase_vocoder_tpu import pipeline as jpipeline
from phase_vocoder_tpu.ops.pallas import fused as jfused
from phase_vocoder_tpu.ops.pallas import stft as jstft
import phase_vocoder_tpu_torch as tpv
from phase_vocoder_tpu_torch import pipeline
from phase_vocoder_tpu_torch.ops import fused, stft
from tests.conftest import make_test_signal

N, RA = 1024, 256
NB = N // 2 + 1
CFG = tpv.PvocConfig()
JAX_CFG = jpv.PvocConfig(fft_backend="pallas")


def rel_err(a, b, edge=N):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert len(a) == len(b), (len(a), len(b))
    sl = slice(edge, len(a) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


@pytest.fixture(scope="module")
def x1():
    return make_test_signal(1.0).astype(np.float32)


@pytest.fixture(scope="module")
def x4():
    return make_test_signal(4.0)


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("rs", [640, 768, 767])
def test_phasor_terms_vs_jax(rs, scan, x1):
    j = jfused.stft_phasor_terms(jnp.asarray(x1), N, RA, rs, scan=scan, return_u=True)
    nf = j[-1]
    jm, jpre, jpim, jure, juim = (np.asarray(a)[:nf, :NB] for a in j[:5])
    t = fused.stft_phasor_terms(torch.as_tensor(x1), N, RA, rs, scan=scan, return_u=True)
    assert t[-1] == nf
    tm, tpre, tpim, ture, tuim = (a.numpy() for a in t[:5])
    assert tm.shape == (nf, NB)
    top = np.abs(jm).max()
    assert np.abs(tm - jm).max() / top <= 2e-6
    weight = jm / top
    for (ar, ai), (br, bi) in (((tpre, tpim), (jpre, jpim)), ((ture, tuim), (jure, juim))):
        assert (np.abs((ar + 1j * ai) - (br + 1j * bi)) * weight).max() <= 1e-4
    if scan:
        assert np.abs(np.hypot(tpre, tpim) - 1).max() < 1e-6


def test_phasor_terms_return_forms(x1):
    """Without return_u: (mag, pre, pim, nf), equal to the return_u call's
    first three; the first frame's term is the anchor u_0."""
    x = torch.as_tensor(x1)
    a = fused.stft_phasor_terms(x, N, RA, 640, scan=False)
    b = fused.stft_phasor_terms(x, N, RA, 640, scan=False, return_u=True)
    assert len(a) == 4 and len(b) == 6 and a[-1] == b[-1]
    for u, v in zip(a[:3], b[:3]):
        assert torch.equal(u, v)
    assert torch.equal(a[1][0], b[3][0]) and torch.equal(a[2][0], b[4][0])


def test_phasor_terms_rejects_unsupported(x1):
    with pytest.raises(ValueError, match="n_fft"):
        fused.stft_phasor_terms(torch.as_tensor(x1), 1536, 1024, 640)  # hop does not divide
    with pytest.raises(ValueError, match="n_fft"):
        fused.stft_phasor_terms(torch.as_tensor(x1), 8192, 2048, 640)  # above 4096
    with pytest.raises(ValueError, match="shorter"):
        fused.stft_phasor_terms(torch.zeros(100), N, RA, 640)


@pytest.fixture(scope="module")
def spectra():
    g = np.random.default_rng(0)
    a = g.random((120, NB)).astype(np.float32)
    b = (g.random((120, NB)) * 7.0 - 3.5).astype(np.float32)
    mask = np.ones(120, np.float32)
    mask[-10:] = 0.0
    return a, b, mask


@pytest.mark.parametrize("cart", [False, True])
def test_istft_frames_vs_jax(cart, spectra):
    a, b, mask = spectra
    jfn, tfn = (jstft.istft_frames_cart, stft.istft_frames_cart) if cart else (
        jstft.istft_frames, stft.istft_frames)
    j = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b), N, frame_mask=jnp.asarray(mask)))
    t = tfn(torch.as_tensor(a), torch.as_tensor(b), N, frame_mask=torch.as_tensor(mask)).numpy()
    assert t.shape == (120, N)
    assert np.abs(t - j).max() <= 1e-4 * np.abs(j).max()
    assert not t[-10:].any()  # masked frames are exact zeros


def test_istft_frames_cart_equals_polar_form(spectra):
    """The cartesian form of mag e^{i psi} gives the polar form's frames."""
    a, b, _ = spectra
    mag, psi = torch.as_tensor(a), torch.as_tensor(b)
    polar = stft.istft_frames(mag, psi, N)
    cart = stft.istft_frames_cart(mag * torch.cos(psi), mag * torch.sin(psi), N)
    assert torch.equal(polar, cart)


@pytest.mark.parametrize("stretch", [2.5, 3.0])
def test_time_stretch_general_vs_jax_and_golden(stretch, x4):
    y = tpv.time_stretch(x4, stretch, device="cpu").numpy()
    j = np.asarray(jpv.time_stretch(x4, stretch, JAX_CFG))
    assert rel_err(y, j) <= 5e-5
    ref = pv_ref.phase_vocoder(x4, stretch, N, RA)
    assert rel_err(y, ref) < 1e-4


def test_phasor_general_stretch_is_the_route(x4):
    x = torch.as_tensor(x4, dtype=torch.float32)
    assert pipeline.phasor_general_ok(CFG, 768) and not pipeline.phasor_general_ok(CFG, 512)
    assert not pipeline.phasor_general_ok(tpv.PvocConfig(fft_backend="matmul"), 768)
    assert torch.equal(pipeline.phasor_general_stretch(x, CFG, 768), tpv.time_stretch(x, 3.0))
    j = np.asarray(jpipeline.phasor_general_stretch(jnp.asarray(x4, jnp.float32), JAX_CFG, 768))
    assert rel_err(pipeline.phasor_general_stretch(x, CFG, 768).numpy(), j) <= 5e-5


def test_pitch_shift_plus_19_vs_jax_and_golden(x4):
    """+19 st: Rs = 767 > N/2, k = 767/256 in the angle domain."""
    assert CFG.synthesis_hop(2.0 ** (19 / 12)) == 767
    y = tpv.pitch_shift(x4, 19.0, device="cpu").numpy()
    j = np.asarray(jpv.pitch_shift(x4, 19.0, JAX_CFG))
    assert rel_err(y, j) < 1e-4
    ref = pv_ref.pitch_shift(x4, 19.0, N, RA)
    assert abs(len(y) - len(ref)) <= 1
    n = min(len(y), len(ref))
    assert rel_err(y[:n], ref[:n]) < 1e-3


def test_synthesize_polar_general_hop_vs_jax(x1):
    """Rs = 171 does not divide N: istft_frames and fold OLA on the fused
    backend, JAX's istft_frames kernel on its side."""
    mag, phi = pipeline.analyze(torch.as_tensor(x1), CFG)
    mag, psi = pipeline.stretch_polar(mag, phi, CFG, 171)
    y = pipeline.synthesize_polar(mag, psi, CFG, 171).numpy()
    j = np.asarray(jpipeline.synthesize_polar(jnp.asarray(mag.numpy()), jnp.asarray(psi.numpy()),
                                              JAX_CFG, 171))
    assert rel_err(y, j) <= 5e-5
    mask = torch.ones(mag.shape[0])
    mask[-5:] = 0.0
    ym = pipeline.synthesize_polar(mag, psi, CFG, 171, frame_mask=mask).numpy()
    jm = np.asarray(jpipeline.synthesize_polar(
        jnp.asarray(mag.numpy()), jnp.asarray(psi.numpy()), JAX_CFG, 171,
        frame_mask=jnp.asarray(mask.numpy())))
    assert rel_err(ym, jm) <= 5e-5
