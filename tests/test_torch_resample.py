"""The port's resampler (ops/resample.py) on CPU tensors against the
float64 golden model and the JAX package's resample_linear.

Bounds: < 2e-6 abs to the golden model (one f32 rounding of the lerp on
|x| <= 1); < 1e-6 abs to the JAX package, whose block-split positions
agree with float64 to ~6e-8 samples.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from golden import pv_ref
from phase_vocoder_tpu.ops.resample import resample_linear as jax_resample
from phase_vocoder_tpu_torch.ops.resample import (
    resample_linear,
    resample_linear_reference,
)
from tests.conftest import make_test_signal

SEMITONES = [-13, -12, -7, -5, 0, 5, 7, 12, 3.5]


@pytest.fixture(scope="module")
def x():
    return make_test_signal(2.0).astype(np.float32)


def _port(x, factor, out_len):
    return resample_linear(torch.as_tensor(x), factor, out_len).numpy()


@pytest.mark.parametrize("st", SEMITONES)
def test_resample_vs_golden(st, x):
    fac = 1.0 / (2.0 ** (st / 12.0))  # what pitch_shift passes
    out_len = int(round(len(x) * fac))
    ref = pv_ref.resample_linear(x.astype(np.float64), fac, out_len)
    assert np.max(np.abs(_port(x, fac, out_len) - ref)) < 2e-6


@pytest.mark.parametrize("st", SEMITONES)
def test_resample_vs_jax(st, x):
    fac = 1.0 / (2.0 ** (st / 12.0))
    out_len = int(round(len(x) * fac))
    j = np.asarray(jax_resample(jnp.asarray(x), fac, out_len))
    assert np.max(np.abs(_port(x, fac, out_len) - j)) < 1e-6


@pytest.mark.parametrize(
    "n,fac,out_len",
    [(10, 0.37, 31), (5, 3.0, 2), (1, 0.5, 3), (128, 1.0, 128), (64, 0.5, 4000), (1, 0.8, 50)],
)
def test_resample_edge_shapes(n, fac, out_len):
    """Tiny inputs and outputs far past the input's end (edge clamp)."""
    g = np.random.default_rng(n)
    x = g.uniform(-1, 1, n).astype(np.float32)
    y = _port(x, fac, out_len)
    ref = pv_ref.resample_linear(x.astype(np.float64), fac, out_len)
    assert y.shape == (out_len,)
    assert np.max(np.abs(y - ref)) < 2e-6
    if fac >= 0.5:  # the JAX step > 2 kernel takes ~30 s in interpret mode
        j = np.asarray(jax_resample(jnp.asarray(x), fac, out_len))
        assert np.max(np.abs(y - j)) < 1e-6


def test_resample_degenerate_sizes():
    x = torch.ones(4)
    assert resample_linear(x, 2.0, 0).shape == (0,)
    assert torch.equal(resample_linear(torch.ones(0), 2.0, 3), torch.zeros(3))


def test_resample_wrapper_checks():
    x = torch.ones(16)
    assert torch.equal(resample_linear(x, 1.5, 24), resample_linear_reference(x, 1.5, 24))
    with pytest.raises(ValueError):
        resample_linear(x.double(), 1.5, 24)
    with pytest.raises(ValueError):
        resample_linear(torch.ones(2, 8), 1.5, 24)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        resample_linear(x.to("meta"), 1.5, 24)
