"""The port's polar analysis and synthesis (ops/stft.py), DFT dispatch
(ops/fft.py) and overlap-add (ops/framing.py) on CPU tensors, where the
kernel wrappers run their plain torch versions, against the JAX package
(its Pallas kernels in interpret mode, as its own tests run them).

Bounds:
  * stft_polar magnitude < 1e-5 rel to max |X| (both f32 DFTs, ~5e-7
    measured). The phase is compared modulo 2 pi and weighted by the bin's
    magnitude: a spectrum error e moves the phase of a bin of magnitude |X|
    by up to e/|X|, so |wrap(phi_a - phi_b)| * |X| <= 5e-6 max |X| (the
    complex spectra agree to ~6e-7 of max |X|); a phase near +-pi may land
    on either side, which the wrap absorbs.
  * istft_ola < 1e-5 interior rel (f32 inverse FFT vs f32 matrix DFT,
    ~1.6e-6 measured), with and without a frame mask.
  * stft_fused (re, im) < 1e-5 of max |X| from JAX's stft_fused (both f32
    DFTs, the same agreement as stft_polar's magnitude).
  * The real-input transform of csrc/fft_real.cuh, written out in float64
    torch (pack, stages, post-twiddle split; pre-twiddle merge, stages,
    unpack): <= 1e-12 of the largest value from torch.fft.rfft / irfft.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phase_vocoder_tpu.ops import fft as jfft
from phase_vocoder_tpu.ops import framing as jframing
from phase_vocoder_tpu.ops.pallas import istft_ola as jax_istft_ola
from phase_vocoder_tpu.ops.pallas import stft_polar as jax_stft_polar
from phase_vocoder_tpu.ops.pallas.stft import stft_fused as jax_stft_fused
from phase_vocoder_tpu_torch import pipeline
from phase_vocoder_tpu_torch.ops import fft as tfft
from phase_vocoder_tpu_torch.ops import framing
from phase_vocoder_tpu_torch.ops.stft import (
    istft_ola,
    istft_ola_reference,
    stft_fused,
    stft_fused_reference,
    stft_polar,
)
from phase_vocoder_tpu_torch.ops.window import hann_window
from tests.conftest import make_test_signal

N, RA = 1024, 256


def interior_rel(a, b, edge=N):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert len(a) == len(b), (len(a), len(b))
    sl = slice(edge, len(a) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


@pytest.fixture(scope="module")
def x2():
    return make_test_signal(2.0).astype(np.float32)


@pytest.fixture(scope="module")
def jax_spec(x2):
    mag, phi = jax_stft_polar(jnp.asarray(x2), N, RA)
    return np.array(mag), np.array(phi)


# ---------------------------------------------------------------- analysis


def test_stft_polar_vs_jax(x2, jax_spec):
    jm, jp = jax_spec
    tm, tp = (t.numpy() for t in stft_polar(torch.as_tensor(x2), N, RA))
    assert tm.shape == jm.shape == (framing.num_frames(len(x2), N, RA), N // 2 + 1)
    top = jm.max()
    assert np.max(np.abs(tm - jm)) / top < 1e-5
    dphi = np.abs(np.angle(np.exp(1j * (tp.astype(np.float64) - jp))))
    assert np.max(dphi * jm) <= 5e-6 * top
    assert np.all(np.abs(tp) <= np.float32(np.pi))


def test_stft_polar_short_and_bad_geometry():
    mag, phi = stft_polar(torch.zeros(100), N, RA)
    assert mag.shape == phi.shape == (0, N // 2 + 1)
    with pytest.raises(ValueError):
        stft_polar(torch.zeros(4096), N, 300)  # hop does not divide n_fft
    mag, phi = stft_polar(torch.zeros(4096), 1536, 256)  # any even n_fft up to 4096
    assert mag.shape == phi.shape == (11, 769)
    with pytest.raises(ValueError):
        stft_polar(torch.zeros(8192), 1535, 307)  # odd n_fft
    with pytest.raises(ValueError):
        stft_polar(torch.zeros(8192), 8192, 2048)  # above 4096
    with pytest.raises(ValueError):
        stft_polar(torch.zeros(4096, dtype=torch.float64), N, RA)


@pytest.mark.parametrize("n_fft,hop,seconds", [(512, 128, 2.0), (1024, 256, 2.0), (1024, 256, 0.1)])
def test_stft_fused_vs_jax(n_fft, hop, seconds, x2):
    x = x2[: int(seconds * 16000)]
    jre, jim = (np.asarray(a) for a in jax_stft_fused(jnp.asarray(x), n_fft, hop))
    tre, tim = (t.numpy() for t in stft_fused(torch.as_tensor(x), n_fft, hop))
    assert tre.shape == tim.shape == jre.shape == (framing.num_frames(len(x), n_fft, hop), n_fft // 2 + 1)
    top = np.max(np.hypot(jre, jim))
    assert max(np.max(np.abs(tre - jre)), np.max(np.abs(tim - jim))) / top < 1e-5
    # the polar form is the same spectrum
    mag, phi = stft_polar(torch.as_tensor(x), n_fft, hop)
    assert torch.allclose(torch.polar(mag, phi), torch.complex(*stft_fused_reference(torch.as_tensor(x), n_fft, hop)),
                          rtol=0, atol=1e-6 * float(top))


def test_stft_fused_short_and_bad_geometry():
    re, im = stft_fused(torch.zeros(100), N, RA)
    assert re.shape == im.shape == (0, N // 2 + 1)
    with pytest.raises(ValueError, match="hop"):
        stft_fused(torch.zeros(4096), N, 300)  # hop does not divide n_fft
    with pytest.raises(ValueError):
        stft_fused(torch.zeros(8192), 1535, 307)  # odd n_fft
    with pytest.raises(ValueError):
        stft_fused(torch.zeros(16384), 8192, 2048)  # above 4096
    with pytest.raises(ValueError):
        stft_fused(torch.zeros((2, 4096)), N, RA)  # not 1-D


def test_analysis_whole_signal_equals_per_segment(x2):
    """The streaming executor analyses the padded signal once and hands
    each segment its rows: bitwise what analysing segment by segment
    gives, since every frame is transformed on its own."""
    cfg = pipeline.PvocConfig()
    x = torch.as_tensor(x2)
    mag, phi = pipeline.analyze(x, cfg)
    F = 40
    for s in range(0, mag.shape[0] - F, F):
        seg = x[s * RA : (s + F) * RA + N - RA]
        m, p = pipeline.analyze(seg, cfg)
        assert torch.equal(m, mag[s : s + F]) and torch.equal(p, phi[s : s + F])


# --------------------------------------------------------------- synthesis


@pytest.mark.parametrize("rs", [128, 256, 512])
def test_istft_ola_vs_jax(rs, jax_spec):
    jm, jp = jax_spec
    j = np.asarray(jax_istft_ola(jnp.asarray(jm), jnp.asarray(jp), N, rs))
    t = istft_ola(torch.as_tensor(jm), torch.as_tensor(jp), N, rs).numpy()
    assert len(t) == len(j) == (jm.shape[0] - 1) * rs + N
    assert interior_rel(t, j) < 1e-5


@pytest.mark.parametrize("rs", [128, 512])
def test_istft_ola_frame_mask_vs_jax(rs, jax_spec):
    """Masked frames contribute nothing: equal to JAX's masked call and,
    past the last unmasked frame, exactly zero."""
    jm, jp = jax_spec
    mask = np.ones(jm.shape[0], np.float32)
    mask[-30:] = 0.0
    mask[10] = 0.0
    j = np.asarray(jax_istft_ola(jnp.asarray(jm), jnp.asarray(jp), N, rs,
                                 frame_mask=jnp.asarray(mask)))
    t = istft_ola(torch.as_tensor(jm), torch.as_tensor(jp), N, rs,
                  frame_mask=torch.as_tensor(mask)).numpy()
    assert interior_rel(t, j, edge=N) < 1e-5
    end = (jm.shape[0] - 30 - 1) * rs + N
    assert np.all(t[end:] == 0.0)


def test_istft_ola_drops_real_bin_imaginary_parts():
    """At DC and Nyquist psi is 0 or +-pi plus a multiple of pi, whose
    float32 sine is not zero (sin(f32(pi)) = -8.7e-8): the imaginary parts
    there are dropped, as a real inverse transform does. psi = pi and -pi
    at both bins give the same output, equal to a float64 numpy irfft that
    drops them."""
    g = np.random.default_rng(3)
    nf, nb = 12, N // 2 + 1
    mag = g.uniform(0.5, 2.0, (nf, nb)).astype(np.float32)
    psi = g.uniform(-np.pi, np.pi, (nf, nb)).astype(np.float32)
    psi[:, 0] = psi[:, -1] = np.float32(np.pi)
    a = istft_ola_reference(torch.as_tensor(mag), torch.as_tensor(psi), N, 256)
    psi_neg = psi.copy()
    psi_neg[:, 0] = psi_neg[:, -1] = -np.float32(np.pi)
    b = istft_ola_reference(torch.as_tensor(mag), torch.as_tensor(psi_neg), N, 256)
    assert torch.equal(a, b)
    y = mag.astype(np.float64) * np.exp(1j * psi.astype(np.float64))
    y[:, 0] = y[:, 0].real
    y[:, -1] = y[:, -1].real
    frames = np.fft.irfft(y, n=N, axis=-1) * hann_window(N).double().numpy()
    ref = np.zeros((nf - 1) * 256 + N)
    for i in range(nf):
        ref[i * 256 : i * 256 + N] += frames[i]
    assert np.max(np.abs(a.numpy() - ref)) / np.max(np.abs(ref)) < 1e-6


def test_istft_ola_rejects_geometry_like_jax(jax_spec):
    jm, jp = (torch.as_tensor(a) for a in jax_spec)
    with pytest.raises(ValueError):
        istft_ola(jm, jp, N, 333)  # rs does not divide n_fft
    with pytest.raises(ValueError):
        istft_ola(jm, jp, N, N)  # no overlap
    with pytest.raises(ValueError):
        istft_ola(jm[:, :-1], jp[:, :-1], N, 256)
    assert istft_ola(jm[:0], jp[:0], N, 256).shape == (0,)


def test_wrappers_never_run_the_plain_version_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device launches
    the kernel or raises (here, the meta device raises)."""
    x = torch.zeros(4096, device="meta")
    with pytest.raises(ValueError, match="device"):
        stft_polar(x, N, RA)
    with pytest.raises(ValueError, match="device"):
        stft_fused(x, N, RA)
    m = torch.zeros((5, N // 2 + 1), device="meta")
    with pytest.raises(ValueError, match="device"):
        istft_ola(m, m, N, 256)


# ------------------------------------ the transform of csrc/fft_real.cuh


def _stages(log2n: int) -> list[int]:
    """Plan<LOG2N>: log2 of each stage's radix, the radix-16 stages first."""
    m = log2n - 1
    s = (m + 3) // 4
    return [4 if i < m - 3 * s else 3 for i in range(s)]


def _real_fft_m(z: torch.Tensor, log2n: int, fwd: bool, tc, ts) -> torch.Tensor:
    """fft() of csrc/fft_real.cuh in float64: the M = N/2-point Stockham
    FFT, thread t holding butterflies j = t + T kk, with each stage's
    source index, the twiddle build_twiddles gathers from the N-point
    table (entry 2e, negated past the half circle), and the dest index."""
    M = 1 << (log2n - 1)
    T = M // 16
    d = -1.0 if fwd else 1.0
    buf, lns = z, 0
    for lr in _stages(log2n):
        R = 1 << lr
        r = torch.arange(R)
        j = (torch.arange(T)[:, None] + T * torch.arange(16 // R)[None, :])[..., None]
        v = buf[j + r * (M >> lr)]  # source<P, s>
        q = j & ((1 << lns) - 1)
        k = 2 * ((r * q) << (log2n - 1 - lns - lr))  # build_twiddles: W_M^e at table entry 2e
        neg = k >= M
        h = torch.where(neg, k - M, k)
        c = torch.where(neg, -tc[h], tc[h])
        sn = torch.where(neg, -ts[h], ts[h])
        v = v * torch.complex(c, d * sn)
        w = torch.exp(d * 2j * math.pi * torch.outer(r, r).double() / R)
        v = v @ w  # the R-point DFT in registers
        out = torch.empty(M, dtype=torch.complex128)
        out[((j - q) << lr) + q + (r << lns)] = v  # dest<P, s>
        buf, lns = out, lns + lr
    return buf


@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_real_transform_formulas_float64(n_fft):
    """stft.cu's pack / post-twiddle split (stft_real_kernel) and
    pre-twiddle merge / unpack (istft_real_kernel) around fft_real.cuh's
    stages, as the source orders them, against torch.fft.rfft and irfft;
    DC, Nyquist and bin N/4 checked on their own as well."""
    log2n = n_fft.bit_length() - 1
    M = n_fft // 2
    g = np.random.default_rng(n_fft)
    kk = torch.arange(M, dtype=torch.float64)
    tc, ts = torch.cos(2 * math.pi * kk / n_fft), torch.sin(2 * math.pi * kk / n_fft)
    w = hann_window(n_fft).double()
    # analysis
    gx = torch.as_tensor(g.standard_normal(n_fft)) * w
    Z = _real_fft_m(torch.complex(gx[0::2], gx[1::2]), log2n, True, tc, ts)
    k = torch.arange(M + 1)
    a = torch.where(k == M, 0, k)
    b = torch.where(k == 0, 0, M - k)
    zr, zi, mr, mi = Z.real[a], Z.imag[a], Z.real[b], -Z.imag[b]
    er, ei = 0.5 * (zr + mr), 0.5 * (zi + mi)
    pr, pi = 0.5 * (zi - mi), -0.5 * (zr - mr)
    wr = torch.where(k < M, tc[k % M], torch.tensor(-1.0, dtype=torch.float64))
    wi = torch.where(k < M, -ts[k % M], torch.tensor(0.0, dtype=torch.float64))
    X = torch.complex(er + (pr * wr - pi * wi), ei + (pr * wi + pi * wr))
    ref = torch.fft.rfft(gx)
    top = float(ref.abs().max())
    assert float((X - ref).abs().max()) <= 1e-12 * top
    for bin_ in (0, M, n_fft // 4):
        assert abs(complex(X[bin_] - ref[bin_])) <= 1e-12 * top
    assert X[0].imag == 0.0 and X[M].imag == 0.0
    # synthesis
    Y = torch.complex(torch.as_tensor(g.standard_normal(M + 1)), torch.as_tensor(g.standard_normal(M + 1)))
    Y.imag[0] = Y.imag[M] = 0.0  # dropped, as the kernel drops them
    n = torch.arange(M)
    yr, yi = Y.real[n], Y.imag[n]
    cr, ci = Y.real[M - n], -Y.imag[M - n]
    sr, si, dr, di = yr + cr, yi + ci, yr - cr, yi - ci
    z = _real_fft_m(torch.complex(sr - (tc * di + ts * dr), si + (tc * dr - ts * di)), log2n, False, tc, ts)
    out = torch.empty(n_fft, dtype=torch.float64)
    out[0::2] = z.real / n_fft * w[0::2]
    out[1::2] = z.imag / n_fft * w[1::2]
    ref = torch.fft.irfft(Y, n=n_fft) * w
    assert float((out - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


# --------------------------------------------------------------- ops/fft.py


@pytest.mark.parametrize("window", [False, True])
def test_dft_matrices_bitwise(window):
    for jf, tf in ((jfft._dft_matrices, tfft._dft_matrices),
                   (jfft._idft_matrices, tfft._idft_matrices)):
        for a, b in zip(jf(N, window), tf(N, window)):
            assert np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("backend,fused_window", [("matmul", False), ("matmul", True), ("xla", False)])
def test_rfft_irfft_vs_jax(backend, fused_window, x2):
    frames = np.ascontiguousarray(
        framing.frame_signal(torch.as_tensor(x2), N, RA).numpy()[:40]
    )
    jre, jim = jfft.rfft(jnp.asarray(frames), backend=backend, fused_window=fused_window)
    tre, tim = tfft.rfft(torch.as_tensor(frames), backend=backend, fused_window=fused_window)
    top = np.max(np.abs(np.asarray(jre)))
    assert np.max(np.abs(tre.numpy() - np.asarray(jre))) / top < 1e-5
    assert np.max(np.abs(tim.numpy() - np.asarray(jim))) / top < 1e-5
    j = np.asarray(jfft.irfft(jre, jim, N, backend=backend, fused_window=fused_window))
    t = tfft.irfft(tre, tim, N, backend=backend, fused_window=fused_window).numpy()
    assert np.max(np.abs(t - j)) / np.max(np.abs(j)) < 1e-5


def test_fused_window_needs_matmul_and_unknown_backend():
    f = torch.zeros((2, N))
    with pytest.raises(ValueError):
        tfft.rfft(f, backend="xla", fused_window=True)
    with pytest.raises(ValueError):
        tfft.irfft(f[:, : N // 2 + 1], f[:, : N // 2 + 1], N, backend="xla", fused_window=True)
    with pytest.raises(ValueError):
        tfft.rfft(f, backend="bogus")


def test_matmul_dft_refuses_tf32():
    """The DFT products run in full FP32 or not at all."""
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="FP32"):
            tfft.rfft(torch.zeros((2, N)), backend="matmul")
    finally:
        torch.set_float32_matmul_precision(old)


# ----------------------------------------------------------- ops/framing.py


@pytest.mark.parametrize("hop", [128, 171, 256, 384])
def test_overlap_add_scatter_vs_fold_and_jax(hop):
    g = np.random.default_rng(hop)
    frames = g.standard_normal((37, N)).astype(np.float32)
    fold = framing.overlap_add(torch.as_tensor(frames), hop, method="fold").numpy()
    scat = framing.overlap_add(torch.as_tensor(frames), hop, method="scatter").numpy()
    j = np.asarray(jframing.overlap_add(jnp.asarray(frames), hop, method="scatter"))
    ref = np.zeros(len(j))
    for i in range(37):
        ref[i * hop : i * hop + N] += frames[i]
    assert len(fold) == len(scat) == len(j)
    for y in (fold, scat, j):
        assert np.max(np.abs(y - ref)) < 1e-5
    again = framing.overlap_add(torch.as_tensor(frames), hop, method="scatter").numpy()
    assert np.array_equal(scat, again)
    with pytest.raises(ValueError):
        framing.overlap_add(torch.as_tensor(frames), hop, method="bogus")


@pytest.mark.parametrize("method", ["fold", "scatter"])
@pytest.mark.parametrize("masked", [False, True])
def test_ola_window_norm_vs_jax(method, masked):
    nf, rs = 30, 128
    mask = np.ones(nf, np.float32)
    if masked:
        mask[-7:] = 0.0
        mask[3] = 0.0
    jw = jnp.asarray(hann_window(N).numpy())
    j = np.asarray(jframing.ola_window_norm(
        jw, nf, rs, eps=0.0, method=method,
        frame_mask=jnp.asarray(mask) if masked else None))
    t = framing.ola_window_norm(
        hann_window(N), nf, rs, eps=0.0, method=method,
        frame_mask=torch.as_tensor(mask) if masked else None).numpy()
    assert np.max(np.abs(t - j)) < 1e-6
    t_eps = framing.ola_window_norm(hann_window(N), nf, rs, method=method).numpy()
    assert t_eps.min() >= 1e-8
