"""The synthesis of csrc/pvoc_fused.cu on csrc/fft_real.cuh's body
(synth_real), written out in float64 torch on the CPU: a CUDA kernel has
no interpret mode, so its index arithmetic and formulas are held here and
the kernel itself against its plain version on the card (chip_smoke.py).

What the twin follows, as the source orders it: the frame groups of every
batch row flattened (group gi is row gi // per_row, frames
(gi % per_row) F + slot, F = 8192 / N), a group wholly past its row's
frames skipped, a frame past them written nowhere; Y read from one of the
two sources, with the imaginary parts of DC and Nyquist dropped:
  * packed rows [re(nb) | im(nb)] at row stride 2 nb (the phase passes' y);
  * the planes mag, pre, pim (B, nf, nb) and the optional mask (B, nf):
    re = (mag pre) mask, im = (mag pim) mask (phasor_y's order);
then the pre-twiddle merge, fft_real.cuh's inverse stages and the unpack
to samples 2n, 2n+1, / N, windowed.

Bounds: <= 1e-12 of the largest value from torch.fft.irfft(Y) * w per
frame (float64 throughout), and from _synth_reference (ops/fused.py, the
plain version of phasor_istft_ola) on a masked case after the overlap-add.
"""

import math

import numpy as np
import pytest
import torch

from phase_vocoder_tpu_torch.ops import fused
from phase_vocoder_tpu_torch.ops.window import hann_window
from tests.test_torch_stft import _real_fft_m


def _tables(n_fft: int):
    k = torch.arange(n_fft // 2, dtype=torch.float64)
    return torch.cos(2 * math.pi * k / n_fft), torch.sin(2 * math.pi * k / n_fft)


def _synth_real_twin(n_fft: int, nf: int, nfs: list, load) -> torch.Tensor:
    """synth_real over len(nfs) batch rows of nf frames in the buffers, row
    b's first nfs[b] live; load(fr, k) gives (re, im) of bins k of the
    frame at buffer row fr. Returns the (B*nf, N) frames buffer, NaN where
    the kernel writes nothing."""
    log2n = n_fft.bit_length() - 1
    M, F = n_fft // 2, 8192 // n_fft
    tc, ts = _tables(n_fft)
    w = hann_window(n_fft).double()
    frames = torch.full((len(nfs) * nf, n_fft), math.nan, dtype=torch.float64)
    per_row = -(-nf // F)
    k = torch.arange(M + 1)
    n = torch.arange(M)
    for gi in range(per_row * len(nfs)):
        bat = gi // per_row
        i0 = (gi - bat * per_row) * F
        if i0 >= nfs[bat]:
            continue
        for slot in range(F):
            i = i0 + slot
            if i >= nfs[bat]:
                continue
            fr = bat * nf + i
            re, im = load(fr, k)
            im = torch.where((k == 0) | (k == M), 0.0, im)
            yr, yi = re[n], im[n]
            cr, ci = re[M - n], -im[M - n]  # conj Y[M-n]
            sr, si, dr, di = yr + cr, yi + ci, yr - cr, yi - ci
            z = _real_fft_m(torch.complex(sr - (tc * di + ts * dr), si + (tc * dr - ts * di)),
                            log2n, False, tc, ts)
            frames[fr, 0::2] = z.real / n_fft * w[0::2]
            frames[fr, 1::2] = z.imag / n_fft * w[1::2]
    return frames


def _irfft_frames(re: torch.Tensor, im: torch.Tensor, n_fft: int) -> torch.Tensor:
    """torch.fft.irfft of rows (re, im) with DC and Nyquist imaginary parts
    dropped, windowed."""
    im = im.clone()
    im[..., 0] = im[..., -1] = 0.0
    return torch.fft.irfft(torch.complex(re, im), n=n_fft, dim=-1) * hann_window(n_fft).double()


@pytest.mark.parametrize("source", ["packed", "planes"])
@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_synth_real_sources_float64(n_fft, source):
    """Both sources of synth_real over a ragged batch of three rows (one
    shorter than a frame group, one with no frames): every live frame
    equals irfft(Y) * w; frames past a row's count are not written."""
    nb, F = n_fft // 2 + 1, 8192 // n_fft
    nf = 2 * F + 3
    nfs = [nf, F - 1, 0]
    B = len(nfs)
    g = np.random.default_rng(n_fft)
    if source == "packed":
        y = torch.as_tensor(g.standard_normal(B * nf * 2 * nb))  # (B*nf, 2*nb), flat

        def load(fr, k):
            return y[fr * 2 * nb + k], y[fr * 2 * nb + nb + k]

        rows = y.reshape(B * nf, 2 * nb)
        re, im = rows[:, :nb], rows[:, nb:]
    else:
        mag, pre, pim = (torch.as_tensor(g.standard_normal(B * nf * nb)) for _ in range(3))
        mask = torch.as_tensor(g.uniform(0.0, 1.0, B * nf))

        def load(fr, k):
            e = fr * nb + k
            return (mag[e] * pre[e]) * mask[fr], (mag[e] * pim[e]) * mask[fr]

        re = (mag * pre).reshape(B * nf, nb) * mask[:, None]
        im = (mag * pim).reshape(B * nf, nb) * mask[:, None]
    out = _synth_real_twin(n_fft, nf, nfs, load)
    ref = _irfft_frames(re, im, n_fft)
    for b, n_b in enumerate(nfs):
        live = slice(b * nf, b * nf + n_b)
        dead = slice(b * nf + n_b, (b + 1) * nf)
        if n_b:
            top = float(ref[live].abs().max())
            assert float((out[live] - ref[live]).abs().max()) <= 1e-12 * top
        assert bool(out[dead].isnan().all())


@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_synth_real_planes_masked_vs_synth_reference(n_fft):
    """The planes source with a frame mask (a zero, a fraction, ones), then
    the fold overlap-add, against _synth_reference, the plain version of
    phasor_istft_ola with a mask, in float64."""
    nb, rs = n_fft // 2 + 1, n_fft // 4
    nf = 8192 // n_fft + 5
    g = np.random.default_rng(n_fft + 1)
    mag = torch.as_tensor(g.uniform(0.0, 2.0, (nf, nb)))
    phase = torch.as_tensor(g.uniform(-math.pi, math.pi, (nf, nb)))
    pre, pim = torch.cos(phase), torch.sin(phase)
    mask = torch.ones(nf, dtype=torch.float64)
    mask[2], mask[-1] = 0.0, 0.375

    def load(fr, k):
        return (mag[fr, k] * pre[fr, k]) * mask[fr], (mag[fr, k] * pim[fr, k]) * mask[fr]

    frames = _synth_real_twin(n_fft, nf, [nf], load)
    ola = torch.zeros((nf - 1) * rs + n_fft, dtype=torch.float64)
    for i in range(nf):
        ola[i * rs : i * rs + n_fft] += frames[i]
    ref = fused._synth_reference(mag, pre, pim, n_fft, rs, nf, mask)
    assert ref.dtype == torch.float64 and ref.shape == ola.shape
    assert float((ola - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_real_body_sizes():
    """The N that synth_real serves, as real_fft::real_log2 decides: the
    powers of two from 256 to 4096; every other even N takes fft_synthesis
    and pvoc_phasor_synth's packed-Y scratch."""
    assert [n for n in range(2, 8194, 2) if fused.real_body(n)] == [256, 512, 1024, 2048, 4096]
    src = (fused._build.CSRC / "fft_real.cuh").read_text()
    assert "for (int l = 8; l <= 12; ++l)" in src
