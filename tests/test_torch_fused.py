"""The port's fused TSM (ops/fused.py) on CPU tensors, where the wrapper
runs its plain torch version, against the float64 golden model and the
JAX package's fused kernel (interpret mode on CPU).

Bounds: < 1e-4 interior rel to the golden model (the repository's gate);
< 5e-5 to the JAX kernel — both are ~1e-5 from the golden model, and
tests/test_fused.py holds two f32 paths to the same bound.
"""

import numpy as np
import pytest
import torch

from golden import pv_ref
from phase_vocoder_tpu.ops.pallas.fused import fused_time_stretch as jax_fused
from phase_vocoder_tpu_torch.ops.fused import (
    fused_time_stretch,
    fused_time_stretch_reference,
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
    assert not phasor_supported(1536, 256, 256)  # N not a power of two


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
