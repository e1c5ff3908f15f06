"""phasor_synth_general (ops/fused.py), the synthesis of the general-hop
route (pipeline.phasor_general_stretch): Y = |X| P, the windowed inverse
DFT, the fold-order overlap-add over m = ceil(N/Rs) segments a frame and
the window-energy normalization, at any Rs > 0.

On the CPU, its plain version against the tail that the route ran before
in plain torch: the products mag * P, istft_frames_cart's plain version,
framing.overlap_add(method="fold"), framing.ola_window_norm and the
division, at Rs above N/2, at N and past N, held to 1e-6 of that tail's
largest sample (the normalization now multiplies by a float32 inverse of
a float64 energy where the tail divided by a float32 fold of w^2).

Marked `card` (skipped without a CUDA card): the pvoc_phasor_synth kernel
against the plain version, on the samples whose window energy is at
least 1e-2, at 1e-5 of the largest of them (the bound chip_smoke.py holds
phasor_istft_ola to; where the energy is smaller, 1/energy lifts a lone
frame's edge taps to hundreds and a bound on the whole would hide an
interior error), and silent where no frame reaches; the kernel's frames
(read as the kernel's output at Rs = N with a mask of ones, where each
output row is one frame) against the plain windowed irfft at 1e-6 of
their largest, and its overlap-add bit for bit against the plain fold and
normalization of those frames, at those Rs and at Rs = 256 and 512, where
m = N/Rs; the 2.5x route's launches (the terms, then this synthesis), and
the 3.0x route's (one pvoc_fused launch, phasor_general_closed, against
the chain of the two on the same input).
No JAX here, so that the card tests run where JAX is absent:

    python -m pytest tests/test_torch_general_synth.py --noconftest -m card
"""

import numpy as np
import pytest
import torch

import phase_vocoder_tpu_torch as tpv
from phase_vocoder_tpu_torch.ops import framing, fused, stft
from phase_vocoder_tpu_torch.ops.window import hann_window
from phase_vocoder_tpu_torch.utils import profiling

N = 1024
NB = N // 2 + 1
GENERAL_RS = [600, 767, 768, 1000, 1024, 1500]
FRAMES = [1, 2, 3, 40]


def _planes(nf: int, device="cpu", seed: int = 0):
    """(nf + 2, NB) magnitudes and unit phasors from a seeded generator;
    the last two rows lie past nf and must not count."""
    g = np.random.default_rng(seed)
    mag = g.random((nf + 2, NB)).astype(np.float32)
    ph = g.uniform(-np.pi, np.pi, (nf + 2, NB))
    planes = (mag, np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32))
    return tuple(torch.as_tensor(a, device=device) for a in planes)


def _old_tail(mag, pre, pim, rs: int, nf: int) -> torch.Tensor:
    """The general route's synthesis before phasor_synth_general, op for op."""
    y_re, y_im = mag[:nf] * pre[:nf], mag[:nf] * pim[:nf]
    frames = stft.istft_frames_cart_reference(y_re, y_im, N)
    out = framing.overlap_add(frames, rs, method="fold")
    norm = framing.ola_window_norm(hann_window(N, mag.device), nf, rs, method="fold")
    return out / norm


@pytest.mark.parametrize("nf", FRAMES)
@pytest.mark.parametrize("rs", GENERAL_RS)
def test_plain_version_matches_the_old_tail(rs, nf):
    planes = _planes(nf, seed=rs + nf)
    new = fused.phasor_synth_general(*planes, N, rs, nf)
    old = _old_tail(*planes, rs, nf)
    assert new.shape == old.shape == ((nf - 1) * rs + N,)
    assert torch.equal(new, fused.phasor_synth_general_reference(*planes, N, rs, nf))
    assert float((new - old).abs().max() / old.abs().max()) <= 1e-6
    if rs > N:  # the gaps between frames stay silent
        assert not new.reshape(-1)[N:rs].any()


def test_rejects_what_it_does_not_take():
    planes = _planes(3)
    with pytest.raises(ValueError, match="rs > 0"):
        fused.phasor_synth_general(*planes, N, 0, 3)
    with pytest.raises(ValueError, match="n_fft"):
        fused.phasor_synth_general(*planes, 8192, 768, 3)
    with pytest.raises(ValueError, match="nf="):
        fused.phasor_synth_general(*planes, N, 768, 6)
    with pytest.raises(ValueError, match="bins"):
        fused.phasor_synth_general(*(p[:, :-1] for p in planes), N, 768, 3)


# ------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU form")
    return torch.device("cuda")


def _energy(nf: int, rs: int, device) -> torch.Tensor:
    """Each output sample's window energy: the fold of w^2, unclamped, in
    float64."""
    w = hann_window(N, device, torch.float64)
    return framing.ola_window_norm(w, nf, rs, eps=0.0, method="fold")


@pytest.mark.card
@pytest.mark.parametrize("nf", FRAMES + [5000])
@pytest.mark.parametrize("rs", GENERAL_RS)
def test_kernel_matches_the_plain_version(card, rs, nf):
    planes = _planes(nf, card, seed=rs + nf)
    k = fused.phasor_synth_general(*planes, N, rs, nf)
    p = fused.phasor_synth_general_reference(*planes, N, rs, nf)
    assert k.shape == p.shape
    energy = _energy(nf, rs, card)
    held = energy >= 1e-2
    assert float((k - p)[held].abs().max() / p[held].abs().max()) <= 1e-5
    assert not k[energy == 0].any()


@pytest.mark.card
@pytest.mark.parametrize("nf", [1, 2, 3, 40, 5000])
@pytest.mark.parametrize("rs", [256, 512] + GENERAL_RS)
def test_gather_is_the_plain_fold_of_its_frames_bit_for_bit(card, rs, nf):
    """The kernel's windowed frames are the plain irfft's; each sample sums
    them oldest first from zero, then takes its row's inverse energy: the
    plain fold and normalization of the kernel's own frames, bit for bit,
    so m = ceil(N/Rs) segments a frame (N/Rs at Rs | N, as before). The
    frames never leave the kernel; at Rs = N with a mask of ones (unit
    normalization rows) output row i is 0 + frame i times 1, and a frame's
    bits do not depend on Rs."""
    planes = _planes(nf, card, seed=rs * nf)
    t3 = tuple(t[None] for t in planes)
    out = fused._synth_launch(*t3, N, rs, nf, None, "phasor_synth_general")[0]
    ones = torch.ones((1, nf), device=card)
    frames = fused._synth_launch(*t3, N, N, nf, ones, "phasor_synth_general")[0].reshape(nf, N)
    plain = fused._synth_frames_reference(*planes, N, nf, None)
    assert float((frames - plain).abs().max() / plain.abs().max()) <= 1e-6
    ola = fused._ola_rows_reference(frames, nf, rs, None)
    want = fused._normalize_rows(ola, 0, nf, N, rs).reshape(-1)[: out.shape[0]]
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def _route_launches(x: torch.Tensor, stretch: float) -> tuple[dict, torch.Tensor]:
    """The counters one time_stretch call moves (launches.*, and
    frames_in_synth.* where synth_real analyses the frames), and its
    output."""
    torch.cuda.synchronize()
    before = profiling.counters()
    y = tpv.time_stretch(x, stretch)
    torch.cuda.synchronize()
    after = profiling.counters()
    got = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    assert y.shape[0] == tpv.stretch_output_length(x.shape[0], tpv.PvocConfig(), stretch)
    assert bool(torch.isfinite(y).all())
    return got, y


def _tone(card) -> torch.Tensor:
    t = torch.arange(4 * 16000, dtype=torch.float64, device=card) / 16000
    return (0.4 * torch.sin(2 * torch.pi * 440.0 * t)).to(torch.float32)


@pytest.mark.card
def test_the_general_route_launches_two_entries(card):
    """At q >= 2 (2.5x, Rs = 640) the general route runs the terms, then
    this synthesis."""
    got, _ = _route_launches(_tone(card), 2.5)
    assert got == {"launches.stft_phasor_terms": 1, "launches.phasor_synth_general": 1}


@pytest.mark.card
def test_the_integer_k_general_route_launches_one_entry(card):
    """At 3.0x (Rs = 768, k = 3) the general route's prefix product is the
    closed form: one pvoc_fused launch (phasor_general_closed), its 247
frames counted as analysed inside synth_real. Where the
    window energy is at least 1e-2, within 1e-5 of the float64 reference
    (pvbench/reference/pv64.py; 2.8e-6 for the plain version) and within
    the port's waveform bar, 1e-4, of the terms-plus-synthesis chain on the
    same input, whose prefix product rounds at every frame (1.0e-5 apart
    on an H100)."""
    from pvbench.reference import pv64

    x = _tone(card)
    got, y = _route_launches(x, 3.0)
    # one launch, whose synth_real analyses every frame from x itself
    nf_x = (x.shape[0] - N) // 256 + 1
    assert got == {"launches.phasor_general_closed": 1, "frames_in_synth.phasor_general_closed": nf_x}
    mag, pre, pim, nf = fused.stft_phasor_terms(x, N, 256, 768)
    chain = fused.phasor_synth_general(mag, pre, pim, N, 768, nf)
    ref = pv64.time_stretch(x, 3.0, N, 256)
    held = _energy(nf, 768, card) >= 1e-2

    def rel(a, b):
        return float((a.double() - b.double())[held].abs().max() / b.double()[held].abs().max())

    assert rel(y, ref) <= 1e-5
    assert rel(y, chain) <= 1e-4
