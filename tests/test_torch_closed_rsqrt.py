"""The integer-k closed form as X z^(p-1) (ops/fused.py _closed_y, the
plain version of csrc/pvoc_fused.cu closed_bin): with u = X/|X|,
z = u conj u_0 and |u_0| = 1, |X| u_0 z^p = X z^(p-1), u = X r with r one
correctly rounded reciprocal square root of |X|^2 (_rsqrt_rn, the
kernels' __frsqrt_rn).

On the CPU:
  * _closed_y at p = 1..8 against |X| u_0 z^p evaluated in float64 on
    seeded spectra with exact-zero, tiny (|X|^2 <= 1e-30) and large bins:
    within (1 + 2 p) ulp of |X| where |X|^2 > 1e-30, exactly 0 at 0, and
    |X| in modulus within 2|X| of it in the tiny bins (u = 1 there, as in
    the anchor's unit phasor, so the form keeps X's phase);
  * p = 1 gives X itself, bit for bit;
  * _rsqrt_rn is the correctly rounded 1/sqrt (exact rational bounds on
    a seeded sample in each range of exponents) and equals float64
    1/sqrt rounded once to float32;
  * past p = 8 (the angle domain) _closed_y keeps |X| u_0 z^p.

Marked `card` (skipped without a CUDA card): __frsqrt_rn against the
float64 form over every positive finite float32 bit pattern (a test-only
C entry); synth_real's closed form (pvoc_fused) against phase_closed's on
the same spectra (a test-only entry through phase_closed and synth_real
from its rows) bit for bit at N = 512, 1024, 2048 at 2.0x and 3.0x, and
at 9.0x (the angle domain) at N = 1024; and
batch rows against 1-D calls, streams against the monolithic call and zrev
against pvoc_fused bit for bit at those N (streams and zrev at 2.0x: no
route serves them past Rs = N/2). No JAX here, so that the card tests run
where JAX is absent:

    python -m pytest tests/test_torch_closed_rsqrt.py --noconftest -m card
"""

import ctypes
from fractions import Fraction

import numpy as np
import pytest
import torch

from phase_vocoder_tpu_torch import pipeline, streaming
from phase_vocoder_tpu_torch.bench import utterance
from phase_vocoder_tpu_torch.config import PvocConfig
from phase_vocoder_tpu_torch.ops import _build, fused

SR = 16000
ULP = 2.0**-23  # float32 spacing at 1
TINY = 1e-30


def _spectra(n: int, seed: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """n bins X (float32 re, im): magnitudes from 1e-3 to 1e3, then exact
    zeros, signed zeros, tiny bins (|X|^2 <= 1e-30) and bins on one axis;
    and n anchors u_0, unit phasors rounded to float32."""
    g = np.random.default_rng(seed)
    mag = 10.0 ** g.uniform(-3, 3, n)
    ang = g.uniform(-np.pi, np.pi, n)
    re, im = mag * np.cos(ang), mag * np.sin(ang)
    k = n // 8
    re[:k], im[:k] = 0.0, 0.0
    im[: k // 2] = -0.0
    tiny = 10.0 ** g.uniform(-24, -15.5, k) / np.sqrt(2)
    re[k : 2 * k], im[k : 2 * k] = tiny * np.cos(ang[:k]), tiny * np.sin(ang[:k])
    im[2 * k : 3 * k] = 0.0
    re[3 * k : 4 * k] = 0.0
    a0 = g.uniform(-np.pi, np.pi, n)
    f32 = lambda a: torch.as_tensor(a.astype(np.float32))  # noqa: E731
    return f32(re), f32(im), f32(np.cos(a0)), f32(np.sin(a0))


def _old_form64(re, im, u0re, u0im, p: int) -> np.ndarray:
    """|X| u_0 (u conj u_0)^p in float64, u = X/|X| (1 where the float32
    |X|^2 <= 1e-30, as the kernels classify a bin)."""
    x = re.double().numpy() + 1j * im.double().numpy()
    u0 = u0re.double().numpy() + 1j * u0im.double().numpy()
    safe = (re * re + im * im > TINY).numpy()
    u = np.where(safe, x / np.where(safe, np.abs(x), 1.0), 1.0)
    return np.abs(x) * u0 * (u * np.conj(u0)) ** p


@pytest.mark.parametrize("p", range(1, 9))
def test_closed_form_is_the_old_form_in_float64(p):
    re, im, u0re, u0im = _spectra(20000, seed=p)
    yre, yim = fused._closed_y(re, im, u0re, u0im, p * 256, 256)
    assert yre.dtype == yim.dtype == torch.float32
    y = yre.double().numpy() + 1j * yim.double().numpy()
    want = _old_form64(re, im, u0re, u0im, p)
    x = np.abs(re.double().numpy() + 1j * im.double().numpy())
    n2 = (re * re + im * im).numpy()
    safe, zero = n2 > TINY, x == 0
    tiny = ~safe & ~zero
    assert safe.sum() > 10000 and zero.sum() > 1000 and tiny.sum() > 1000
    err = np.abs(y - want)
    assert np.all(err[safe] <= (1 + 2 * p) * ULP * x[safe]), float(np.max(err[safe] / x[safe]) / ULP)
    assert np.all(y[zero] == 0)
    # the tiny bins: u = 1, so Y = X conj(u_0)^(p-1), |X| in modulus
    assert np.all(np.abs(np.abs(y[tiny]) - x[tiny]) <= (1 + 2 * p) * ULP * x[tiny])
    assert np.all(err[tiny] <= 2 * x[tiny] * (1 + 1e-6))


@pytest.mark.parametrize("shape", [(7,), (3, 511), (1, 1)])
def test_p1_keeps_x_bit_for_bit(shape):
    re, im, u0re, u0im = _spectra(int(np.prod(shape)) * 8, seed=11)
    re, im = re[: int(np.prod(shape))].reshape(shape), im[: int(np.prod(shape))].reshape(shape)
    u0re, u0im = u0re[: shape[-1]], u0im[: shape[-1]]
    yre, yim = fused._closed_y(re, im, u0re, u0im, 256, 256)
    assert torch.equal(yre.view(torch.int32), re.view(torch.int32))
    assert torch.equal(yim.view(torch.int32), im.view(torch.int32))


def _correctly_rounded_rsqrt(x: np.float32, y: np.float32) -> bool:
    """y is 1/sqrt(x) rounded to nearest: the exact value lies between the
    midpoints of y and its float32 neighbours (m_lo^2 x <= 1 <= m_hi^2 x)."""
    lo = np.nextafter(y, np.float32(0))
    hi = np.nextafter(y, np.float32(np.inf))
    fx, fy = Fraction(float(x)), Fraction(float(y))
    m_lo, m_hi = (Fraction(float(lo)) + fy) / 2, (fy + Fraction(float(hi))) / 2
    return m_lo * m_lo * fx <= 1 <= m_hi * m_hi * fx


# float32 bit patterns: subnormals, below 1e-30, around 1, up to the largest
_BANDS = {"subnormal": (1, 0x00800000), "small": (0x00800000, 0x0DA24260),
          "unit": (0x3E800000, 0x40800000), "large": (0x40800000, 0x7F800000)}


@pytest.mark.parametrize("band", sorted(_BANDS))
def test_rsqrt_rn_is_correctly_rounded(band):
    lo, hi = _BANDS[band]
    g = np.random.default_rng(lo)
    bits = np.unique(np.concatenate([g.integers(lo, hi, 3000), [lo, hi - 1]])).astype(np.uint32)
    x = bits.view(np.float32)
    got = fused._rsqrt_rn(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    # float64 1/sqrt rounded once, one value at a time (Python's math is IEEE)
    once = np.array([np.float32(1.0 / np.sqrt(np.float64(v))) for v in x], dtype=np.float32)
    assert np.array_equal(got.view(np.uint32), once.view(np.uint32))
    assert all(_correctly_rounded_rsqrt(v, w) for v, w in zip(x, got))


@pytest.mark.parametrize("p", [9, 12])
def test_past_p8_the_angle_domain_keeps_the_old_form(p):
    re, im, u0re, u0im = _spectra(4000, seed=p)
    yre, yim = fused._closed_y(re, im, u0re, u0im, p * 256, 256)
    mag, ure, uim = fused._unit(re, im)
    wre, wim = fused._pow_k(ure * u0re + uim * u0im, uim * u0re - ure * u0im, p * 256, 256)
    pre, pim = fused._cmul(wre, wim, u0re, u0im)
    assert torch.equal(yre, mag * pre) and torch.equal(yim, mag * pim)


# ------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU form")
    return torch.device("cuda")


def _entry(name: str, argtypes: list):
    fn = getattr(_build.kernels(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


@pytest.mark.card
def test_frsqrt_rn_is_the_float64_form_everywhere(card):
    """__frsqrt_rn(x) == (float)(1.0 / sqrt((double)x)) for every positive
    finite float32 x, the form _rsqrt_rn takes on the CPU."""
    fn = _entry("pvoc_test_rsqrt_sweep",
                [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    count = torch.zeros(1, dtype=torch.int64, device=card)
    first = torch.zeros(16, dtype=torch.int32, device=card)
    lo, n = 1, 0x7F800000 - 1  # bits 1 .. 0x7F7FFFFF
    _build.check(fn(lo, n, count.data_ptr(), first.data_ptr(), _stream()), "pvoc_test_rsqrt_sweep")
    torch.cuda.synchronize()
    bad = int(count.item())
    assert bad == 0, [hex(b) for b in first[: min(bad, 16)].tolist()]


def _signal(seconds: float, seed: int = 0) -> torch.Tensor:
    """chip_smoke.py's test signal, float32, made on the CPU."""
    return torch.as_tensor(utterance(seconds, seed, SR).astype(np.float32))


def _closed_rows(x: torch.Tensor, n_fft: int, hop: int, rs: int) -> torch.Tensor:
    """pvoc_fused's output with the phase in phase_closed's own pass, Y
    through device memory and synth_real reading its rows."""
    fn = _entry("pvoc_test_closed_rows", [*[ctypes.c_void_p] * 6, ctypes.c_longlong,
                                          *[ctypes.c_int] * 5, ctypes.c_float, ctypes.c_void_p])
    nf = fused.num_frames(x.shape[0], n_fft, hop)
    p = rs // hop
    dev = str(x.device)
    fft = fused._device_tables(n_fft, hop, rs, dev)["fft"]
    norm = fused._device_norm_rows(n_fft, rs, min(nf, -(-n_fft // rs) - 1), dev)
    out = torch.empty((nf - 1) * rs + n_fft, dtype=torch.float32, device=x.device)
    spec = torch.empty((nf, n_fft + 2), dtype=torch.float32, device=x.device)
    y = torch.empty_like(spec)
    _build.check(fn(x.data_ptr(), out.data_ptr(), spec.data_ptr(), y.data_ptr(), fft.data_ptr(),
                    norm.data_ptr(), nf, n_fft, hop, rs, p, int(fused._pow_alg(p, 1)),
                    float(np.float32(p)), _stream()), "pvoc_test_closed_rows")
    return out


@pytest.mark.card
@pytest.mark.parametrize("n_fft,hop,k", [(n, n // 4, k) for n in (512, 1024, 2048) for k in (2, 3)]
                         + [(1024, 32, 9)])
def test_synth_real_closed_form_is_phase_closed(card, n_fft, hop, k):
    """k = 9 (Rs = 288 <= N/2) takes the angle domain, closed_bin_angle."""
    x = _signal(30.0, seed=n_fft + k).to(card)
    entry = fused.fused_time_stretch if 2 * k * hop <= n_fft else fused.phasor_general_closed
    got = entry(x, n_fft, hop, k * hop)
    want = _closed_rows(x, n_fft, hop, k * hop)
    assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("ratio", [2.0, 3.0])
@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
def test_batch_rows_are_the_1d_calls(card, n_fft, ratio):
    hop = n_fft // 4
    rs = int(ratio) * hop
    counts = [1, 9, 300, 1200]
    t = n_fft + (max(counts) - 1) * hop
    sig = _signal(t / SR + 3, seed=n_fft)
    xs = torch.stack([sig[i * 5 * hop : i * 5 * hop + t] for i in range(len(counts))]).to(card)
    if ratio == 2.0:
        out = fused.fused_time_stretch_batch(xs, n_fft, hop, rs, counts)
        single = fused.fused_time_stretch
    else:  # Rs > N/2: (C, T) through time_stretch, channel by channel
        cfg = PvocConfig(n_fft=n_fft, hop=hop)
        xs = xs[:, : n_fft + (counts[-1] - 1) * hop].contiguous()
        counts = [counts[-1]] * len(counts)
        out = pipeline.time_stretch(xs, ratio, cfg)
        single = fused.phasor_general_closed
    for b, nf in enumerate(counts):
        y = single(xs[b, : n_fft + (nf - 1) * hop].contiguous(), n_fft, hop, rs)
        assert torch.equal(out[b, : y.shape[0]], y), (b, nf)


@pytest.mark.card
@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
def test_stream_and_zrev_are_pvoc_fused(card, n_fft):
    hop = n_fft // 4
    x = _signal(60.0, seed=5).to(card)
    mono = fused.fused_time_stretch(x, n_fft, hop, 2 * hop)
    stream = streaming.fused_stream_time_stretch(x, 2.0, PvocConfig(n_fft=n_fft, hop=hop),
                                                 segment_frames=256)
    assert torch.equal(stream, mono)
    assert torch.equal(fused.fused_time_stretch(x, n_fft, hop, 2 * hop, zrev=True), mono)
