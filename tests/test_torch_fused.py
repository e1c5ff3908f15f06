"""The port's fused TSM (ops/fused.py) on CPU tensors, where the wrapper
runs its plain torch version, against the float64 golden model and the
JAX package's fused kernel (interpret mode on CPU).

Bounds: < 1e-4 interior rel to the golden model (the repository's gate);
< 5e-5 to the JAX kernel — both are ~1e-5 from the golden model, and
tests/test_fused.py holds two f32 paths to the same bound.

zrev=True (the fold analysis: a half-length transform of the frame's
packed even and odd samples) is held to the same two bounds against the
JAX kernel run with zrev=True and the golden model, and to < 1e-5 interior
rel against zrev=False (another rounding of the forward transform; ~4e-7
measured here). _rfft_fold alone is held to 2e-6 of max |X| against
torch.fft.rfft.
"""

import numpy as np
import pytest
import torch

from golden import pv_ref
from phase_vocoder_tpu.ops.pallas.fused import fused_time_stretch as jax_fused
from phase_vocoder_tpu_torch.ops.fused import (
    _rfft_fold,
    fold_analysis_applies,
    fused_time_stretch,
    fused_time_stretch_reference,
    fused_time_stretch_zrev,
    phasor_supported,
)
from tests.conftest import make_test_signal

N, RA = 1024, 256

# (n_fft, hop, rs): stretch 0.5 / 1.0 / 1.5 / 2.0, k = 4, the -7 st hop.
GEOMETRIES = [
    (N, RA, 128), (N, RA, 256), (N, RA, 384), (N, RA, 512),
    (512, 64, 256), (N, RA, 171),
]


def rel_err(a, b, edge=N):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert len(a) == len(b), (len(a), len(b))
    sl = slice(edge, len(a) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


@pytest.fixture(scope="module")
def x32():
    return make_test_signal(2.0).astype(np.float32)


def _port(x, n_fft, hop, rs):
    return fused_time_stretch(torch.as_tensor(x), n_fft, hop, rs).numpy()


@pytest.mark.parametrize("n_fft,hop,rs", GEOMETRIES)
def test_fused_vs_golden(n_fft, hop, rs, x32):
    ref = pv_ref.phase_vocoder(x32.astype(np.float64), rs / hop, n_fft, hop)
    y = _port(x32, n_fft, hop, rs)
    assert rel_err(y, ref, edge=n_fft) < 1e-4


@pytest.mark.parametrize("n_fft,hop,rs", GEOMETRIES)
def test_fused_vs_jax(n_fft, hop, rs, x32):
    j = np.asarray(jax_fused(x32, n_fft, hop, rs))
    y = _port(x32, n_fft, hop, rs)
    assert rel_err(y, j, edge=n_fft) < 5e-5


def test_fused_awkward_length():
    """Frame count far from any block multiple, OLA spill rows included:
    the exact output length, interior strict, full range loose (the edge
    normalization divides by near-zero window energy)."""
    x = make_test_signal(2.3141).astype(np.float32)
    ref = pv_ref.phase_vocoder(x.astype(np.float64), 2.0, N, RA)
    y = _port(x, N, RA, 512)
    assert len(y) == len(ref)
    assert rel_err(y, ref) < 1e-4
    assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) < 1e-2


@pytest.mark.parametrize("seconds", [0.07, 0.1, 0.15])
def test_fused_short_input(seconds):
    """Fewer frames than the overlap (nf < m - 1 at Rs = 128): every output
    row is normalized by the energy of the frames that cover it."""
    x = make_test_signal(seconds).astype(np.float32)
    ref = pv_ref.phase_vocoder(x.astype(np.float64), 0.5, N, RA)
    y = _port(x, N, RA, 128)
    assert len(y) == len(ref)
    assert rel_err(y, ref, edge=64) < 1e-4


def test_fused_rerun_bitwise(x32):
    """Deterministic overlap-add: two runs are bitwise equal."""
    a = _port(x32, N, RA, 512)
    b = _port(x32, N, RA, 512)
    assert np.array_equal(a, b)


def test_cpu_wrapper_is_the_plain_version(x32):
    x = torch.as_tensor(x32)
    assert torch.equal(
        fused_time_stretch(x, N, RA, 171), fused_time_stretch_reference(x, N, RA, 171)
    )


def test_phasor_supported_matrix():
    assert phasor_supported(1024, 256, 512)
    assert phasor_supported(1024, 256, 128)
    assert phasor_supported(1024, 256, 171)
    assert phasor_supported(512, 64, 256)
    assert not phasor_supported(1024, 256, 513)  # overlap < 2
    assert not phasor_supported(1024, 192, 256)  # Ra does not divide N
    assert phasor_supported(1536, 256, 256)  # any even N up to 4096
    assert phasor_supported(1000, 250, 500) and phasor_supported(896, 224, 448)
    assert not phasor_supported(1535, 307, 307)  # odd N
    assert not phasor_supported(8192, 2048, 4096)  # above 4096


def test_wrapper_rejects_what_the_kernel_does_not_take(x32):
    x = torch.as_tensor(x32)
    with pytest.raises(ValueError):
        fused_time_stretch(x.double(), N, RA, 512)
    with pytest.raises(ValueError):
        fused_time_stretch(x, N, RA, 640)  # Rs > N/2
    with pytest.raises(ValueError):
        fused_time_stretch(x[:100], N, RA, 512)  # shorter than a frame
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        fused_time_stretch(x.to("meta"), N, RA, 512)


# ------------------------------------------------------- zrev: the fold analysis

# k = 2, 1/2, 171/256 at N = 1024, and k = 2 at a non-power-of-two N.
ZREV_GEOMETRIES = [(N, RA, 512), (N, RA, 128), (N, RA, 171), (768, 192, 384)]


@pytest.mark.parametrize("n_fft,hop,rs", ZREV_GEOMETRIES)
def test_zrev_vs_plain_route(n_fft, hop, rs, x32):
    x = torch.as_tensor(x32)
    assert fold_analysis_applies(n_fft, hop)
    z = fused_time_stretch_reference(x, n_fft, hop, rs, zrev=True).numpy()
    a = fused_time_stretch_reference(x, n_fft, hop, rs).numpy()
    assert not np.array_equal(z, a)  # another transform, not an alias
    assert rel_err(z, a, edge=n_fft) < 1e-5


@pytest.mark.parametrize("n_fft,hop,rs", ZREV_GEOMETRIES)
def test_zrev_vs_jax_and_golden(n_fft, hop, rs, x32):
    z = fused_time_stretch(torch.as_tensor(x32), n_fft, hop, rs, zrev=True).numpy()
    j = np.asarray(jax_fused(x32, n_fft, hop, rs, zrev=True))
    ref = pv_ref.phase_vocoder(x32.astype(np.float64), rs / hop, n_fft, hop)
    assert rel_err(z, j, edge=n_fft) < 5e-5
    assert rel_err(z, ref, edge=n_fft) < 1e-4


@pytest.mark.parametrize("n_fft,hop,rs", [(768, 256, 128), (N, 1024, 512), (1002, 167, 167)])
def test_zrev_is_a_no_op_where_the_fold_does_not_apply(n_fft, hop, rs, x32):
    """An odd overlap N/Ra (the JAX rule) or N not a multiple of 4: the
    same call as zrev=False, bit for bit."""
    x = torch.as_tensor(x32)
    assert not fold_analysis_applies(n_fft, hop)
    assert torch.equal(
        fused_time_stretch(x, n_fft, hop, rs, zrev=True), fused_time_stretch(x, n_fft, hop, rs)
    )
    with pytest.raises(ValueError):
        fused_time_stretch_zrev(x, n_fft, hop, rs)


def test_zrev_cpu_wrapper_and_rerun(x32):
    x = torch.as_tensor(x32)
    a = fused_time_stretch(x, N, RA, 171, zrev=True)
    assert torch.equal(a, fused_time_stretch_reference(x, N, RA, 171, zrev=True))
    assert torch.equal(a, fused_time_stretch_zrev(x, N, RA, 171))
    assert torch.equal(a, fused_time_stretch(x, N, RA, 171, zrev=True))
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        fused_time_stretch(x.to("meta"), N, RA, 512, zrev=True)


@pytest.mark.parametrize("n_fft", [1024, 768, 1000, 896, 8])
def test_rfft_fold_is_the_rfft(n_fft):
    g = torch.as_tensor(np.random.default_rng(n_fft).standard_normal((5, n_fft)).astype(np.float32))
    a, b = _rfft_fold(g), torch.fft.rfft(g, dim=-1)
    assert a.shape == b.shape == (5, n_fft // 2 + 1)
    assert float((a - b).abs().max() / b.abs().max()) < 2e-6
    assert float(a.imag[:, 0].abs().max()) == 0.0 and float(a.imag[:, -1].abs().max()) == 0.0
